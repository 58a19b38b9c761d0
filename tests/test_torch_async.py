"""The port's async Algorithm 1 (``mode="async"``) against the JAX
package's, from the same carried-over initial parameters and the same numpy
data: the event trace and the clock equal exactly (both come from the same
numpy-only timeline), the model, losses and accuracy within 1e-5 on the
logreg setup of ``tests/test_fl_async.py`` (fp32 sums in other orders), and
SMOKE-width LeNet within 1e-4 of its largest param."""
import dataclasses

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
from repro_torch.kernels import hier_aggregate as ha  # noqa: E402
from repro_torch.models import lenet as t_lenet  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small operations gain nothing from more,
    and idle threads spinning would slow the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PROBLEM = dict(num_edges=2, num_ues=8, epsilon=0.25, seed=0, samples_lo=50,
               samples_hi=120)
ATOL = 1e-5


def _j_loss(p, b):
    return j_lenet.logreg_loss(p, b, l2=1e-3)


def _t_loss(p, b):
    return t_lenet.logreg_loss(p, b, l2=1e-3)


@pytest.fixture(scope="module")
def setup():
    """``tests/test_fl_async.py``'s logreg setup, for both packages."""
    jsch, tsch = j_plan(JProblem(**PROBLEM)), t_plan(TProblem(**PROBLEM))
    train = synthetic.logreg_data(seed=0, n=800, dim=12, num_classes=4)
    test = synthetic.logreg_data(seed=1, n=200, dim=12, num_classes=4)
    parts = partition.size_partition(np.random.default_rng(0), 800,
                                     tsch.problem.samples.astype(int))
    ue_data = [{k: train[k][ix] for k in train} for ix in parts]
    init = jax.tree.map(np.asarray,
                        j_lenet.logreg_init(jax.random.PRNGKey(0), 12, 4))
    return jsch, tsch, init, ue_data, test


def _jsim(setup, **kw):
    jsch, _, init, ue_data, _ = setup
    return JSim(jsch, _j_loss, init, ue_data, lr=0.02, **kw)


def _tsim(setup, **kw):
    _, tsch, init, ue_data, _ = setup
    return HFLSimulator(tsch, _t_loss, from_jax_params(init, device="cpu"),
                        ue_data, lr=0.02, device="cpu", **kw)


def _trace(tl):
    return [(kind, dataclasses.astuple(ev)) for kind, ev in tl.trace]


def _leaves(params):
    return [np.asarray(x) for x in (tree_leaves(params)
                                    if isinstance(next(iter(
                                        params.values())), torch.Tensor)
                                    else jax.tree.leaves(params))]


def _assert_runs_close(tres, jres, atol=ATOL):
    np.testing.assert_array_equal(tres.times, jres.times)
    np.testing.assert_allclose(tres.test_acc, jres.test_acc, atol=atol)
    np.testing.assert_allclose(tres.test_loss, jres.test_loss, atol=atol)
    np.testing.assert_allclose(tres.train_loss, jres.train_loss, atol=atol)
    for t, j in zip(_leaves(tres.final_params), _leaves(jres.final_params)):
        np.testing.assert_allclose(t, j, atol=atol, rtol=0)


def test_async_staleness_zero_matches_own_sync_run(setup):
    test = setup[4]
    sync = _tsim(setup).run(test, rounds=5)
    asyn = _tsim(setup, mode="async", max_staleness=0).run(test, rounds=5)
    np.testing.assert_allclose(asyn.times, sync.times, rtol=1e-12)
    for name in ("test_loss", "train_loss", "test_acc"):
        np.testing.assert_allclose(getattr(asyn, name), getattr(sync, name),
                                   atol=ATOL)
    for a, s in zip(_leaves(asyn.final_params), _leaves(sync.final_params)):
        np.testing.assert_allclose(a, s, atol=ATOL, rtol=0)
    assert asyn.timeline is not None and sync.timeline is None


def test_async_staleness_two_matches_reference(setup):
    test = setup[4]
    jres = _jsim(setup, mode="async", max_staleness=2).run(test, rounds=4)
    before = dict(ha.launch_counts)
    tres = _tsim(setup, mode="async", max_staleness=2).run(test, rounds=4)
    assert _trace(tres.timeline) == _trace(jres.timeline)
    assert tres.timeline.makespan == jres.timeline.makespan
    _assert_runs_close(tres, jres)
    assert ha.launch_counts == before      # the CPU takes plain versions
    m_active = int((setup[1].assoc.sum(0) > 0).sum())
    assert len(tres.times) == 4 * m_active
    assert tres.times[-1] < 4 * setup[1].cloud_round_time


@pytest.mark.parametrize("max_staleness,eval_every", [(1, 3), (0, 2)])
def test_async_eval_every_matches_reference(setup, max_staleness,
                                            eval_every):
    test = setup[4]
    kw = dict(mode="async", max_staleness=max_staleness)
    jres = _jsim(setup, **kw).run(test, rounds=3, eval_every=eval_every)
    tres = _tsim(setup, **kw).run(test, rounds=3, eval_every=eval_every)
    _assert_runs_close(tres, jres)


def test_async_max_staleness_none_takes_the_schedule_bound(setup):
    sch = dataclasses.replace(setup[1], meta={"max_staleness": 3})
    _, _, init, ue_data, _ = setup
    sim = HFLSimulator(sch, _t_loss, from_jax_params(init, device="cpu"),
                       ue_data, device="cpu", mode="async",
                       max_staleness=None)
    assert sim.max_staleness == 3
    sim = HFLSimulator(setup[1], _t_loss, from_jax_params(init, device="cpu"),
                       ue_data, device="cpu", max_staleness=None)
    assert sim.max_staleness == 0


@pytest.mark.parametrize("kw", [
    dict(mode="bogus"), dict(mode="async", solver="dane"),
    dict(mode="async", max_staleness=-1), dict(max_staleness=-1),
    dict(solver="sgd")])
def test_async_argument_validation_as_reference(setup, kw):
    with pytest.raises(ValueError):
        _tsim(setup, **kw)
    if kw.get("solver") != "sgd":       # the reference runs GD for it
        with pytest.raises(ValueError):
            _jsim(setup, **kw)


def test_async_requires_problem_for_cycle_times(setup):
    _, tsch, init, ue_data, test = setup
    bare = dataclasses.replace(tsch, problem=None)
    sim = HFLSimulator(bare, _t_loss, from_jax_params(init, device="cpu"),
                       ue_data, device="cpu", mode="async")
    with pytest.raises(ValueError, match="problem"):
        sim.run(test, rounds=1)


def test_replay_hooks_match_reference(setup):
    """One departure wave and one merge driven through the public hooks,
    and every read-out hook, against the reference."""
    jsim = _jsim(setup, mode="async", max_staleness=2)
    tsim = _tsim(setup, mode="async", max_staleness=2)
    jg, tg = jsim.cloud_vector(), tsim.cloud_vector()
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=ATOL)
    gids = np.asarray(jsim.group_ids)
    mask = gids == 0
    jsim.replay_departure(jg, mask)
    tsim.replay_departure(tg, mask)
    np.testing.assert_allclose(tsim.flat_state(), jsim.flat_state(),
                               atol=ATOL)
    # rows of the edge in flight did not move
    np.testing.assert_array_equal(tsim.flat_state()[~mask],
                                  np.asarray(jsim.flat_state())[~mask])
    decay = np.array([0.9, 0.0])
    jg2, tg2 = jsim.replay_merge(jg, decay), tsim.replay_merge(tg, decay)
    assert tg2.dtype == torch.float32
    np.testing.assert_allclose(tg2.numpy(), np.asarray(jg2), atol=ATOL)
    for m in range(2):
        np.testing.assert_allclose(tsim.edge_mean_row(m).numpy(),
                                   np.asarray(jsim.edge_mean_row(m)),
                                   atol=ATOL)
        assert tsim.edge_mass(m) == jsim.edge_mass(m)
    idx = [5, 0, 3]
    np.testing.assert_allclose(tsim.hot_rows(idx), jsim.hot_rows(idx),
                               atol=ATOL)
    for t, j in zip(_leaves(tsim.global_from_vector(tg2)),
                    _leaves(jsim.global_from_vector(jg2))):
        np.testing.assert_allclose(t, j, atol=ATOL)
    assert tsim.place_cloud_vector(np.asarray(jg2)).dtype == torch.float32


def test_replay_hooks_refuse_what_is_not_ported(setup):
    """What the hooks refuse, as the reference does: replay in sync mode
    (with or without ``ue_ok=``/``agg_weights=``, which are ported) and a
    flat state of another shape."""
    tsim = _tsim(setup, mode="async")
    g = tsim.cloud_vector()
    mask = np.ones(8, bool)
    sync = _tsim(setup)
    with pytest.raises(RuntimeError, match="mode='async'"):
        sync.replay_departure(g, mask, ue_ok=mask)
    with pytest.raises(RuntimeError, match="mode='async'"):
        sync.replay_departure(g, mask, ue_ok=mask, agg_weights=np.ones(8))
    with pytest.raises(RuntimeError):
        sync.replay_departure(g, mask)
    with pytest.raises(RuntimeError):
        sync.replay_merge(g, np.zeros(2))
    with pytest.raises(ValueError, match="shape"):
        tsim.set_flat_state(np.zeros((3, 3), np.float32))


def test_state_carried_from_reference_mid_run(setup):
    """The reference takes a wave; its flat state and cloud vector load
    into the port, and both take the next merge and wave to the same
    state."""
    jsim = _jsim(setup, mode="async", max_staleness=2)
    tsim = _tsim(setup, mode="async", max_staleness=2)
    gids = np.asarray(jsim.group_ids)
    jg = jsim.cloud_vector()
    jsim.replay_departure(jg, gids == 1)
    tsim.set_flat_state(jsim.flat_state())
    np.testing.assert_array_equal(tsim.flat_state(), jsim.flat_state())
    tg = tsim.place_cloud_vector(np.asarray(jg))
    decay = np.array([0.0, 1.0])
    jg, tg = jsim.replay_merge(jg, decay), tsim.replay_merge(tg, decay)
    jsim.replay_departure(jg, gids == 1)
    tsim.replay_departure(tg, gids == 1)
    np.testing.assert_allclose(tsim.flat_state(), jsim.flat_state(),
                               atol=ATOL)
    np.testing.assert_allclose(tsim.cloud_vector().numpy(),
                               np.asarray(jsim.cloud_vector()), atol=ATOL)


def test_lenet_short_async_run_matches_reference():
    """SMOKE-width LeNet, async at max_staleness=2 with a=5, b=3 for one
    round's quota: params within 1e-4 of their largest magnitude (the same
    rule as ``test_lenet_short_round_matches_reference``)."""
    jsch, tsch = j_plan(JProblem(**PROBLEM)), t_plan(TProblem(**PROBLEM))
    jsch = dataclasses.replace(jsch, a=5, b=3)
    tsch = dataclasses.replace(tsch, a=5, b=3)
    train, test = synthetic.synthetic_mnist(seed=0, n_train=400, n_test=64)
    parts = partition.size_partition(np.random.default_rng(0), 400,
                                     tsch.problem.samples.astype(int))
    ue_data = [{k: train[k][ix] for k in train} for ix in parts]
    init = jax.tree.map(np.asarray, jax.jit(
        lambda k: j_lenet.lenet_init(k, J_SMOKE))(jax.random.PRNGKey(0)))
    kw = dict(lr=0.05, samples_per_ue=8, mode="async", max_staleness=2)
    jres = JSim(jsch, j_lenet.lenet_loss, init, ue_data, **kw).run(test,
                                                                   rounds=1)
    tres = HFLSimulator(tsch, t_lenet.lenet_loss,
                        from_jax_params(init, device="cpu"), ue_data,
                        device="cpu", **kw).run(test, rounds=1)
    assert _trace(tres.timeline) == _trace(jres.timeline)
    np.testing.assert_array_equal(tres.times, jres.times)
    jp, tp = _leaves(jres.final_params), _leaves(tres.final_params)
    scale = max(float(np.abs(x).max()) for x in jp)
    assert max(float(np.abs(t - j).max()) for t, j in zip(tp, jp)) <= \
        1e-4 * scale
    assert np.isfinite(tres.test_loss).all()
