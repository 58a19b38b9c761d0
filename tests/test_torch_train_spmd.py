"""The transformer's training half on meshes of gloo ranks (CPU), against
the JAX package.

* The paper's schedule over transformer replicas (``launch/train.py
  --mode hfl``'s round): ``fl.spmd.make_hfl_cloud_round(model.loss, ...)``
  of a smoke StableLM on ``make_fl_mesh(2, 2)``, 4 ranks, each UE its own
  batch, against the reference's ``make_hfl_cloud_round`` of its own
  ``Model.loss`` on 4 placeholder CPU devices in a subprocess
  (``XLA_FLAGS=--xla_force_host_platform_device_count=4`` before JAX is
  imported; the test process has one device).  Every rank's params
  within 1e-5 of that leaf's largest reference magnitude.  The port's
  ranks build the model with ``remat=False``: the local steps take
  ``torch.func``'s vmap of grad, which runs no ``torch.utils.checkpoint``.
  The same round of a smoke Mixtral (the MoE FFN: routing, capacity
  bins and the experts' products under ``torch.func.vmap(grad)``) under
  the same rule.
* ``make_local_sgd_train_step`` on a 2-rank 'data' mesh
  (``make_agg_mesh(1, 2)``), 4 SGD steps with an edge sync after step 2
  and a cloud sync after step 4 (a = b = 2), each rank its own batches,
  against the reference's ``make_train_step`` run per replica with the
  params averaged in numpy at the same steps: losses within 1e-5
  relative, params leaf by leaf within 1e-5 of the leaf's scale.  (SGD,
  not AdamW: AdamW's early steps move an element whose gradient is near
  rounding by up to ``lr`` either way, and here one embedding element's
  gradient at rank 1's second step is 4.8e-7 in the reference and
  -4.4e-7 in the port, 3.7e-6 of the leaf's largest gradient.  AdamW
  through the train step is held in ``tests/test_torch_train.py``.)
* ``python -m repro_torch.launch.train --mode hfl --device cpu`` end to
  end: 4 spawned ranks, finite losses, every rank the same model.

One ``run_ranks`` spawn per world size; JAX is imported only inside the
tests and the reference's subprocess.
"""
import datetime
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.data.synthetic import TokenStream  # noqa: E402
from repro_torch.fl import spmd  # noqa: E402
from repro_torch.fl.flatten import tree_leaves  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.mesh import (make_agg_mesh, make_fl_mesh,  # noqa: E402
                                     run_ranks)
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402

SPAWN_TIMEOUT_S = 150
REL = 1e-5
ARCH = "stablelm-1.6b"
MOE_ARCH = "mixtral-8x7b"
E, U = 2, 2
A, B, LR = 2, 2, 0.1            # the cloud round: a local GD steps x b
BATCH, SEQ = 2, 16
SGD_STEPS, SGD_LR = 4, 0.1      # local SGD: syncs after steps 2 and 4

REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import sys; sys.path.insert(0, sys.argv[1])
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs.base import get_config
    from repro.data.synthetic import TokenStream
    from repro.fl.spmd import make_hfl_cloud_round, stack_for_mesh
    from repro.launch.mesh import make_fl_mesh
    from repro.models.model import Model
    E, U, A, B, LR, BATCH, SEQ = [float(x) if "." in x else int(x)
                                  for x in sys.argv[3:10]]
    model = Model(get_config(sys.argv[10], smoke=True))
    init = model.init(jax.random.PRNGKey(0))
    stream = TokenStream(model.cfg.vocab_size, seed=0)
    per_ue = [stream.batch(BATCH, SEQ, step=i) for i in range(E * U)]
    batch = {k: jnp.stack([b[k] for b in per_ue]) for k in per_ue[0]}
    weights = jnp.arange(1.0, E * U + 1.0)
    fn = make_hfl_cloud_round(model.loss, make_fl_mesh(E, U), a=A, b=B,
                              lr=LR)
    out = fn(stack_for_mesh(init, E, U), batch, weights)
    np.savez(sys.argv[2], **{f"init{i}": np.asarray(x) for i, x in
                             enumerate(jax.tree.leaves(init))},
             **{f"out{i}": np.asarray(x) for i, x in
                enumerate(jax.tree.leaves(out))})
    print("OK")
""")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _timeout():
    return datetime.timedelta(seconds=SPAWN_TIMEOUT_S)


def _model(arch=ARCH):
    return Model(t_base.get_config(arch, smoke=True), impl="xla_flash",
                 remat=False, device="cpu")


def _tree_of(model, leaves):
    """``leaves`` (in flat order) as the model's parameter tree."""
    from repro_torch.fl.flatten import tree_flatten, tree_unflatten
    paths, _ = tree_flatten(model.param_specs())
    return tree_unflatten(paths, [torch.tensor(x) for x in leaves])


def _ue_batches(arch=ARCH):
    stream = TokenStream(t_base.get_config(arch, smoke=True).vocab_size,
                         seed=0)
    per_ue = [stream.batch(BATCH, SEQ, step=i) for i in range(E * U)]
    return {k: np.stack([b[k] for b in per_ue]) for k in per_ue[0]}


def _hfl_rank(init_leaves, arch=ARCH):
    torch.set_num_threads(1)
    mesh = make_fl_mesh(E, U, device="cpu", timeout=_timeout())
    model = _model(arch)
    stacked = spmd.stack_for_mesh(_tree_of(model, init_leaves), E, U)
    fn = spmd.make_hfl_cloud_round(model.loss, mesh, a=A, b=B, lr=LR)
    out = fn(mesh.local(stacked), mesh.local(_ue_batches(arch)),
             mesh.local(np.arange(1.0, E * U + 1.0, dtype=np.float32)))
    return [t[0].clone() for t in tree_leaves(out)]


def _sync_of(i: int):
    """The sync after step ``i`` (0-based) at a = b = 2."""
    n = i + 1
    return "cloud" if n % (A * B) == 0 else "edge" if n % A == 0 else None


def _local_sgd_batch(rank: int, i: int) -> dict:
    stream = TokenStream(t_base.get_config(ARCH, smoke=True).vocab_size,
                         seed=0)
    return stream.batch(BATCH, SEQ, step=100 * rank + i)


def _local_sgd_rank(init_leaves):
    torch.set_num_threads(1)
    mesh = make_agg_mesh(1, 2, device="cpu", timeout=_timeout())
    model = _model()
    params = _tree_of(model, init_leaves)
    opt = sgd(SGD_LR)
    state = opt.init(params)
    step = spmd.make_local_sgd_train_step(model, opt, mesh=mesh, a=A, b=B)
    losses = []
    for i in range(SGD_STEPS):
        params, state, mets = step(params, state,
                                   _local_sgd_batch(mesh.rank, i),
                                   _sync_of(i))
        losses.append(float(mets["loss"]))
    with pytest.raises(ValueError, match="sync"):
        step(params, state, _local_sgd_batch(mesh.rank, 0), "pod")
    return {"losses": losses, "params": tree_leaves(params)}


def _reference_round(tmp_path_factory, arch):
    """The reference's cloud round of ``arch``'s smoke model in a
    subprocess: (init leaves, round's output leaves), numpy."""
    path = tmp_path_factory.mktemp("ref") / "hfl.npz"
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    r = subprocess.run([sys.executable, "-c", REFERENCE, src, str(path),
                        *map(str, (E, U, A, B, LR, BATCH, SEQ)), arch],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    z = np.load(path)
    n = sum(k.startswith("init") for k in z.files)
    return ([z[f"init{i}"] for i in range(n)],
            [z[f"out{i}"] for i in range(n)])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return _reference_round(tmp_path_factory, ARCH)


def _hold_round(reference, arch):
    init, want = reference
    ranks = run_ranks(_hfl_rank, E * U, init, arch, device="cpu",
                      timeout_s=SPAWN_TIMEOUT_S)
    for r, leaves in enumerate(ranks):
        assert len(leaves) == len(want)
        for i, (a, b) in enumerate(zip(leaves, want)):
            err = float(np.abs(a.numpy() - b[r]).max())
            assert err <= REL * float(np.abs(b).max()), (r, i, err)
    # the cloud event leaves every rank the same model
    for leaves in ranks[1:]:
        assert all(torch.equal(a, b) for a, b in zip(leaves, ranks[0]))


def test_hfl_cloud_round_matches_reference(reference):
    _hold_round(reference, ARCH)


def test_hfl_cloud_round_of_an_moe_matches_reference(tmp_path_factory):
    """The MoE FFN under the round's ``torch.func.vmap(grad)``."""
    _hold_round(_reference_round(tmp_path_factory, MOE_ARCH), MOE_ARCH)


def _reference_local_sgd(init):
    """The reference's ``make_train_step`` per replica, params averaged in
    numpy after the steps that sync.  Returns (losses per rank, params per
    rank)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config
    from repro.launch.steps import make_train_step
    from repro.models.model import Model as JModel
    from repro.optim import sgd as j_sgd
    jm = JModel(get_config(ARCH, smoke=True))
    treedef = jax.tree.structure(jm.init(jax.random.PRNGKey(0)))
    opt = j_sgd(SGD_LR)
    fn = jax.jit(make_train_step(jm, opt))
    params = [jax.tree.unflatten(treedef, [jnp.asarray(x) for x in init])
              for _ in range(2)]
    states = [opt.init(p) for p in params]
    losses = [[], []]
    for i in range(SGD_STEPS):
        for r in range(2):
            b = jax.tree.map(jnp.asarray, _local_sgd_batch(r, i))
            params[r], states[r], mets = fn(params[r], states[r], b)
            losses[r].append(float(mets["loss"]))
        if _sync_of(i):
            mean = [(np.asarray(a) + np.asarray(b)) / 2 for a, b in zip(
                jax.tree.leaves(params[0]), jax.tree.leaves(params[1]))]
            params = [jax.tree.unflatten(treedef, [jnp.asarray(m)
                                                   for m in mean])
                      for _ in range(2)]
    return losses, [[np.asarray(x) for x in jax.tree.leaves(p)]
                    for p in params]


def test_local_sgd_train_step_matches_reference(reference):
    init, _ = reference
    ranks = run_ranks(_local_sgd_rank, 2, init, device="cpu",
                      timeout_s=SPAWN_TIMEOUT_S)
    j_losses, j_params = _reference_local_sgd(init)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["losses"], j_losses[r], rtol=REL)
        for i, (a, b) in enumerate(zip(got["params"], j_params[r])):
            err = float(np.abs(a.numpy() - b).max())
            assert err <= REL * float(np.abs(b).max()), (r, i, err)
    # the last step synced over the whole mesh
    assert all(torch.equal(a, b) for a, b in zip(ranks[0]["params"],
                                                 ranks[1]["params"]))


def test_train_main_hfl_runs_on_ranks(capsys):
    out = train.main(["--mode", "hfl", "--smoke", "--device", "cpu",
                      "--rounds", "1", "--batch", "2", "--seq", "16"])
    sch, ranks = out["schedule"], out["ranks"]
    assert [r["rank"] for r in ranks] == list(range(E * U))
    assert all(len(r["losses"]) == 1 and np.isfinite(r["losses"]).all()
               for r in ranks)
    for r in ranks[1:]:
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(r["params"]), tree_leaves(ranks[0]["params"])))
    text = capsys.readouterr().out
    assert f"HFL schedule: a={sch.a} b={sch.b}" in text
