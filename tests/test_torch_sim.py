"""The port's synchronous Algorithm 1 against the JAX package's, from the
same carried-over initial parameters and the same numpy data, plus the
port's boundaries: no JAX, nothing of ``repro``, no silent CPU."""
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.lenet_mnist import SMOKE_CONFIG as J_SMOKE  # noqa: E402
from repro.core import plan as j_plan  # noqa: E402
from repro.core.problem import HFLProblem as JProblem  # noqa: E402
from repro.fl.sim import HFLSimulator as JSim  # noqa: E402
from repro.models import lenet as j_lenet  # noqa: E402
from repro_torch.core import plan as t_plan  # noqa: E402
from repro_torch.core.problem import HFLProblem as TProblem  # noqa: E402
from repro_torch.data import partition, synthetic  # noqa: E402
from repro_torch.fl.flatten import tree_leaves  # noqa: E402
from repro_torch.fl.sim import HFLSimulator  # noqa: E402
from repro_torch.models import lenet as t_lenet  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUICKSTART = dict(num_edges=2, num_ues=8, epsilon=0.25, seed=0,
                  samples_lo=50, samples_hi=120)


def _ue_data(train, n, samples):
    parts = partition.size_partition(np.random.default_rng(0), n,
                                     samples.astype(int))
    return [{k: train[k][ix] for k in train} for ix in parts]


def test_quickstart_logreg_run_matches_reference():
    """The README quickstart's synchronous run: equal clock and accuracy,
    losses within 1e-5 (fp32 sums in other orders)."""
    jsch, tsch = j_plan(JProblem(**QUICKSTART)), t_plan(TProblem(**QUICKSTART))
    train = synthetic.logreg_data(seed=0, n=800, dim=12, num_classes=4)
    test = synthetic.logreg_data(seed=1, n=200, dim=12, num_classes=4)
    ue_data = _ue_data(train, 800, tsch.problem.samples)
    init = jax.tree.map(np.asarray,
                        j_lenet.logreg_init(jax.random.PRNGKey(0), 12, 4))
    jres = JSim(jsch, lambda p, b: j_lenet.logreg_loss(p, b, l2=1e-3),
                init, ue_data, lr=0.02).run(test, rounds=4)
    tres = HFLSimulator(tsch, lambda p, b: t_lenet.logreg_loss(p, b, l2=1e-3),
                        from_jax_params(init, device="cpu"), ue_data,
                        lr=0.02, device="cpu").run(test, rounds=4)
    np.testing.assert_array_equal(tres.times, jres.times)
    np.testing.assert_array_equal(tres.test_acc, jres.test_acc)
    np.testing.assert_allclose(tres.test_loss, jres.test_loss, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tres.train_loss, jres.train_loss, rtol=0,
                               atol=1e-5)


def _lenet_round(a=None, b=None, init_noise=0.0):
    """One cloud round of SMOKE-width LeNet in both packages from the same
    init; returns (reference params, port params, reference params from an
    init perturbed by ``init_noise`` relative)."""
    jsch, tsch = j_plan(JProblem(**QUICKSTART)), t_plan(TProblem(**QUICKSTART))
    if a is not None:
        jsch = dataclasses.replace(jsch, a=a, b=b)
        tsch = dataclasses.replace(tsch, a=a, b=b)
    train, test = synthetic.synthetic_mnist(seed=0, n_train=400, n_test=64)
    ue_data = _ue_data(train, 400, tsch.problem.samples)
    init = jax.tree.map(np.asarray, jax.jit(
        lambda k: j_lenet.lenet_init(k, J_SMOKE))(jax.random.PRNGKey(0)))

    def ref(params):
        return [np.asarray(x) for x in jax.tree.leaves(
            JSim(jsch, j_lenet.lenet_loss, params, ue_data, lr=0.05,
                 samples_per_ue=8).run(test, rounds=1).final_params)]

    port = HFLSimulator(tsch, t_lenet.lenet_loss,
                        from_jax_params(init, device="cpu"), ue_data,
                        lr=0.05, samples_per_ue=8, device="cpu")
    tp = [t.numpy() for t in tree_leaves(port.run(test, rounds=1)
                                         .final_params)]
    perturbed = None
    if init_noise:
        rng = np.random.default_rng(1)
        perturbed = ref(jax.tree.map(
            lambda x: (x * (1 + init_noise * rng.standard_normal(x.shape)))
            .astype(np.float32), init))
    return ref(init), tp, perturbed


def _max_diff(xs, ys):
    return max(float(np.abs(x - y).max()) for x, y in zip(xs, ys))


def test_lenet_short_round_matches_reference():
    """SMOKE-width LeNet, one cloud round of a=5 local steps and b=3 edge
    aggregations: the params agree to 1e-4 of their largest magnitude
    (fp32 sums in other orders, compounded over 15 GD steps)."""
    jp, tp, _ = _lenet_round(a=5, b=3)
    scale = max(float(np.abs(x).max()) for x in jp)
    assert _max_diff(jp, tp) <= 1e-4 * scale


def test_lenet_planned_round_within_reference_sensitivity():
    """The planned round (a*=30, b*=7: 210 GD steps) amplifies float32
    rounding far past 1e-4: moving the reference's own init by 1e-7
    relative moves its result visibly.  The port, whose sums differ from
    the reference's only in order, must stay within 3x that spread."""
    jp, tp, jq = _lenet_round(init_noise=1e-7)
    spread = _max_diff(jp, jq)
    assert spread > 0
    assert _max_diff(jp, tp) <= 3 * spread


def _small_sim_args():
    sch = t_plan(TProblem(**QUICKSTART))
    train = synthetic.logreg_data(seed=0, n=200, dim=6, num_classes=3)
    return (sch, lambda p, b: t_lenet.logreg_loss(p, b),
            {"w": np.zeros((6, 3), np.float32),
             "b": np.zeros(3, np.float32)},
            _ue_data(train, 200, sch.problem.samples))


@pytest.mark.parametrize("kw", [
    {"mode": "async", "delay_model": object()},
    {"solver": "dane", "sampler": object()},
    {"mode": "async", "mesh": object()},
    {"delay_model": object()}, {"fault_model": object()},
    {"sampler": object()}])
def test_unported_features_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        HFLSimulator(*_small_sim_args(), device="cpu", **kw)


@pytest.mark.parametrize("mu", [0.1, 0.5])
def test_dane_round_matches_reference(mu):
    """``solver="dane"`` on the quickstart's logreg setup: one cloud round
    in both packages, losses and the model within 1e-5."""
    jsch, tsch = j_plan(JProblem(**QUICKSTART)), t_plan(TProblem(**QUICKSTART))
    train = synthetic.logreg_data(seed=0, n=800, dim=12, num_classes=4)
    test = synthetic.logreg_data(seed=1, n=200, dim=12, num_classes=4)
    ue_data = _ue_data(train, 800, tsch.problem.samples)
    init = jax.tree.map(np.asarray,
                        j_lenet.logreg_init(jax.random.PRNGKey(0), 12, 4))
    kw = dict(lr=0.02, solver="dane", dane_mu=mu)
    jres = JSim(jsch, lambda p, b: j_lenet.logreg_loss(p, b, l2=1e-3),
                init, ue_data, **kw).run(test, rounds=1)
    tres = HFLSimulator(tsch, lambda p, b: t_lenet.logreg_loss(p, b, l2=1e-3),
                        from_jax_params(init, device="cpu"), ue_data,
                        device="cpu", **kw).run(test, rounds=1)
    np.testing.assert_array_equal(tres.times, jres.times)
    np.testing.assert_allclose(tres.test_loss, jres.test_loss, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tres.train_loss, jres.train_loss, rtol=0,
                               atol=1e-5)
    for t, j in zip(tree_leaves(tres.final_params),
                    jax.tree.leaves(jres.final_params)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-5)


def test_dane_local_steps_and_global_gradient_match_reference():
    """The DANE solver's pieces on stacked logreg params that differ per
    UE: the global gradient and ``a`` = 4 prox-regularised steps, 1e-5."""
    from repro.fl import clients as j_clients
    from repro_torch.fl import clients as t_clients
    rng = np.random.default_rng(2)
    n = 5
    params = {"w": rng.normal(0, 0.3, (n, 6, 3)).astype(np.float32),
              "b": rng.normal(0, 0.3, (n, 3)).astype(np.float32)}
    batches = {"images": rng.normal(0, 1, (n, 7, 6)).astype(np.float32),
               "labels": rng.integers(0, 3, (n, 7)).astype(np.int32)}
    w = rng.uniform(50, 120, n).astype(np.float32)
    j_loss = lambda p, b: j_lenet.logreg_loss(p, b, l2=1e-3)  # noqa: E731
    t_loss = lambda p, b: t_lenet.logreg_loss(p, b, l2=1e-3)  # noqa: E731
    jp = jax.tree.map(jax.numpy.asarray, params)
    jb = jax.tree.map(jax.numpy.asarray, batches)
    j_gbar = j_clients.global_gradient(j_loss, jp, jb, jax.numpy.asarray(w))
    j_out = jax.vmap(lambda p, b: j_clients.dane_local_steps(
        j_loss, 4, 0.05, mu_prox=0.3)(p, b, j_gbar))(jp, jb)
    tp = from_jax_params(params, device="cpu")
    tb = {k: torch.as_tensor(v) for k, v in batches.items()}
    t_gbar = t_clients.global_gradient(t_loss, tp, tb, torch.from_numpy(w))
    for t, j in zip(tree_leaves(t_gbar), jax.tree.leaves(j_gbar)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)
    t_out = t_clients.dane_local_steps(t_loss, 4, 0.05, mu_prox=0.3)(
        tp, tb, t_gbar)
    assert t_out is tp                      # in place, as gd_local_steps
    for t, j in zip(tree_leaves(t_out), jax.tree.leaves(j_out)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)


def test_non_fp32_params_are_rejected():
    sch, loss, init, ue = _small_sim_args()
    with pytest.raises(ValueError, match="float32"):
        HFLSimulator(sch, loss, {k: v.astype(np.float64)
                                 for k, v in init.items()}, ue, device="cpu")


def test_entry_points_never_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HFLSimulator(*_small_sim_args())
    with pytest.raises(RuntimeError):
        t_lenet.lenet_init(torch.Generator(), t_lenet.LeNetConfig())
    with pytest.raises(RuntimeError):
        t_lenet.logreg_init(6, 3)
    with pytest.raises(RuntimeError):
        from_jax_params({"w": np.zeros(2)})


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and\n"
        "       (m == 'repro' or m.startswith(('repro.', 'jax')))]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 20


def test_no_source_imports_repro_or_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "src", "repro_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    pat = re.compile(r"^\s*(import|from)\s+(repro|jax)(\.|\s|$)", re.M)
    offenders = [f for f in files if pat.search(open(f).read())]
    assert not offenders, offenders
    assert len(files) >= 20
