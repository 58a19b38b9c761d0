"""The port's stochastic delay clock (``repro_torch.core.stochastic``, the
draw paths of ``repro_torch.core.delay``, ``refined(objective=
"quantile_makespan")`` and ``HFLSimulator(delay_model=)``) against the JAX
package's.

* Fed the reference's own variates (``JaxKey``, the port's key protocol
  over ``jax.random``), every hook, driver and scenario of the port equals
  the reference's within rtol 1e-6 (float32 ``exp``/``log2`` may differ by
  an ulp between torch and XLA).
* ``DeterministicDelays`` equals the reference exactly, masks or none.
* A model that returns one injected float64 cycle matrix gives the same
  event trace and results, event for event, in ``async_completion``,
  ``makespan_distribution``, ``crn_async_makespans`` and the simulator's
  clock; the model within 1e-5 (logreg) and 1e-4 (SMOKE LeNet).
* The port's own draws: same seed, same rows; two ``CycleTimeSource``s
  agree in any order; the first two moments of 4,096 draws within 4
  standard errors of the reference's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _jax_key import JaxKey  # noqa: E402

from repro.configs.lenet_mnist import SMOKE_CONFIG as J_SMOKE  # noqa: E402
from repro.core import assoc as j_assoc  # noqa: E402
from repro.core import delay as j_delay  # noqa: E402
from repro.core import plan as j_plan  # noqa: E402
from repro.core import stochastic as j_st  # noqa: E402
from repro.core.problem import HFLProblem as JProblem  # noqa: E402
from repro.fl.sim import HFLSimulator as JSim  # noqa: E402
from repro.models import lenet as j_lenet  # noqa: E402
from repro_torch import core as t_core  # noqa: E402
from repro_torch.core import assoc as t_assoc  # noqa: E402
from repro_torch.core import delay as t_delay  # noqa: E402
from repro_torch.core import plan as t_plan  # noqa: E402
from repro_torch.core import stochastic as t_st  # noqa: E402
from repro_torch.core.problem import HFLProblem as TProblem  # noqa: E402
from repro_torch.data import partition, synthetic  # noqa: E402
from repro_torch.fl.flatten import tree_leaves  # noqa: E402
from repro_torch.fl.sim import HFLSimulator  # noqa: E402
from repro_torch.models import lenet as t_lenet  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

RTOL = 1e-6
PROB = dict(num_edges=4, num_ues=24, epsilon=0.25, seed=0)
A_ITERS, B_ITERS = 8, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small operations gain nothing from more,
    and idle threads spinning would slow the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# Every scenario's model, and the hooks' other settings.
EXTRA = {
    "base": ("DelayModel", {}),
    "lognormal_0.5": ("LogNormalCompute", dict(sigma=0.5)),
    "shifted_exp_1": ("ShiftedExpCompute", dict(beta=1.0)),
    "fading_backhaul": ("FadingChannel", dict(rayleigh=True, shadowing_db=6.0,
                                              backhaul_sigma=0.4)),
    "fading_flat": ("FadingChannel", dict(rayleigh=False)),
}
MODELS = sorted(j_st.SCENARIOS) + sorted(EXTRA)


def _models(name):
    if name in EXTRA:
        cls, kw = EXTRA[name]
        return getattr(j_st, cls)(**kw), getattr(t_st, cls)(**kw)
    return j_st.scenario(name).model, t_st.scenario(name).model


@pytest.fixture(scope="module")
def probs():
    jp, tp = JProblem(**PROB), TProblem(**PROB)
    A = j_assoc.proposed(jp)
    np.testing.assert_array_equal(t_assoc.proposed(tp), A)
    return jp, tp, A


def _close(t, j):
    t = t.numpy() if torch.is_tensor(t) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=0)


def _masks(kind, rows, n, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "none":
        return None
    if kind == "ue":
        return rng.random(n) < 0.7
    m = rng.random((rows, n)) < 0.6
    m[0] = False                      # a draw with every cohort masked out
    return m


# ---------------------------------------------------------------------------
# The reference's variates through the port's code
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MODELS)
def test_hooks_match_reference_on_its_variates(probs, name):
    jp, tp, A = probs
    jm, tm = _models(name)
    k = jax.random.PRNGKey(11)
    _close(tm.sample_compute(JaxKey(k), tp, 16), jm.sample_compute(k, jp, 16))
    _close(tm.sample_uplink(JaxKey(k), tp, A, 16),
           jm.sample_uplink(k, jp, A, 16))
    _close(tm.sample_backhaul(JaxKey(k), tp, 16),
           jm.sample_backhaul(k, jp, 16))
    assert tm.sample_compute(JaxKey(k), tp, 4).dtype == torch.float32


@pytest.mark.parametrize("mask", ["none", "ue", "per_draw"])
@pytest.mark.parametrize("name", MODELS)
def test_drivers_match_reference_on_its_variates(probs, name, mask):
    jp, tp, A = probs
    jm, tm = _models(name)
    part = _masks(mask, 12, jp.num_ues)
    kw = {} if part is None else {"participation": part}
    k = jax.random.PRNGKey(5)
    tau_t = tm.edge_round_times(JaxKey(k), tp, A, A_ITERS, 12, **kw)
    tau_j = jm.edge_round_times(k, jp, A, A_ITERS, 12, **kw)
    assert tau_t.dtype == np.float64
    _close(tau_t, tau_j)
    cyc_t = tm.cycle_times(JaxKey(k), tp, A, A_ITERS, B_ITERS, 12, **kw)
    cyc_j = jm.cycle_times(k, jp, A, A_ITERS, B_ITERS, 12, **kw)
    assert cyc_t.dtype == np.float64
    _close(cyc_t, cyc_j)
    if mask == "per_draw":
        assert (tau_t[0] == 0).all() and (tau_j[0] == 0).all()


@pytest.mark.parametrize("name", ["urban_stragglers", "flaky_uplink",
                                  "iid_campus"])
def test_cycle_time_chunks_and_sources_match_reference(probs, name):
    jp, tp, A = probs
    jm, tm = _models(name)
    k = jax.random.PRNGKey(9)
    for chunk in (0, 3):
        _close(t_st.cycle_times_chunk(tm, JaxKey(k), tp, A, A_ITERS, B_ITERS,
                                      chunk, block=8),
               j_st.cycle_times_chunk(jm, k, jp, A, A_ITERS, B_ITERS, chunk,
                                      block=8))
    ts = t_st.CycleTimeSource(tm, JaxKey(k), tp, A, A_ITERS, B_ITERS, block=8)
    js = j_st.CycleTimeSource(jm, k, jp, A, A_ITERS, B_ITERS, block=8)
    for c in (17, 0, 40, 5):
        _close(ts.row(c), js.row(c))
        np.testing.assert_allclose(ts.cost(2, c + 1), js.cost(2, c + 1),
                                   rtol=RTOL)
    with pytest.raises(ValueError):
        t_st.CycleTimeSource(tm, JaxKey(k), tp, A, A_ITERS, B_ITERS, block=0)


def test_unassigned_ues_are_dropped_like_the_reference():
    jp, tp = JProblem(num_edges=3, num_ues=6, seed=2), \
        TProblem(num_edges=3, num_ues=6, seed=2)
    A = np.zeros((6, 3), dtype=np.int64)
    A[0, 0] = A[1, 1] = A[3, 0] = 1          # UEs 2, 4, 5 out; edge 2 empty
    k = jax.random.PRNGKey(0)
    for name in ("urban_stragglers", "base"):
        jm, tm = _models(name)
        _close(tm.cycle_times(JaxKey(k), tp, A, A_ITERS, B_ITERS, 8),
               jm.cycle_times(k, jp, A, A_ITERS, B_ITERS, 8))
    cyc = t_st.scenario("urban_stragglers").model.cycle_times(
        t_st.Key(0, device="cpu"), tp, A, A_ITERS, B_ITERS, 8)
    assert (cyc[:, 2] == 0).all() and (cyc[:, :2] > 0).all()


def test_delay_summaries_match_reference_on_its_variates(probs):
    jp, tp, A = probs
    jm, tm = _models("urban_stragglers")
    k = jax.random.PRNGKey(3)
    ts = t_delay.edge_round_time_stats(tp, A, A_ITERS, model=tm,
                                       key=JaxKey(k), num_samples=64)
    js = j_delay.edge_round_time_stats(jp, A, A_ITERS, model=jm, key=k,
                                       num_samples=64)
    _close(ts["draws"], js["draws"])
    _close(ts["mean"], js["mean"])
    for q in (0.5, 0.95):
        _close(ts["quantiles"][q], js["quantiles"][q])
    _close(t_delay.quantile_edge_round_time(tp, A, A_ITERS, 0.9, model=tm,
                                            key=JaxKey(k), num_samples=64),
           j_delay.quantile_edge_round_time(jp, A, A_ITERS, 0.9, model=jm,
                                            key=k, num_samples=64))
    _close(t_delay.expected_edge_round_time(tp, A, A_ITERS, model=tm,
                                            key=JaxKey(k), num_samples=64),
           j_delay.expected_edge_round_time(jp, A, A_ITERS, model=jm, key=k,
                                            num_samples=64))
    kw = dict(rounds=5, max_staleness=2, num_trials=8)
    td = t_delay.makespan_distribution(tp, A, A_ITERS, B_ITERS, model=tm,
                                       key=JaxKey(k), **kw)
    jd = j_delay.makespan_distribution(jp, A, A_ITERS, B_ITERS, model=jm,
                                       key=k, **kw)
    for key in jd:
        _close(td[key], jd[key])


def test_refined_quantile_matches_reference_on_its_variates():
    """The descent over the reference's draws picks the reference's
    association."""
    kw = dict(num_edges=3, num_ues=12, seed=0, cycles_per_sample_lo=1e3,
              cycles_per_sample_hi=3e5)
    jp, tp = JProblem(**kw), TProblem(**kw)
    args = dict(a=8, objective="quantile_makespan", b=3, rounds=6,
                max_staleness=2, num_trials=12, max_moves=5)
    np.testing.assert_array_equal(
        t_assoc.refined(tp, delay_key=JaxKey(0), **args),
        j_assoc.refined(jp, delay_key=0, **args))


# ---------------------------------------------------------------------------
# DeterministicDelays: exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mask", ["none", "ue", "per_draw"])
def test_deterministic_delays_equal_reference_exactly(probs, mask):
    jp, tp, A = probs
    part = _masks(mask, 5, jp.num_ues, seed=1)
    kw = {} if part is None else {"participation": part}
    td, jd = t_st.DeterministicDelays(), j_st.DeterministicDelays()
    np.testing.assert_array_equal(
        td.edge_round_times(0, tp, A, A_ITERS, 5, **kw),
        jd.edge_round_times(0, jp, A, A_ITERS, 5, **kw))
    np.testing.assert_array_equal(
        td.cycle_times(123, tp, A, A_ITERS, B_ITERS, 5, **kw),
        jd.cycle_times(123, jp, A, A_ITERS, B_ITERS, 5, **kw))
    stats = t_delay.edge_round_time_stats(tp, A, A_ITERS, model=td,
                                          num_samples=8)
    np.testing.assert_array_equal(
        stats["quantiles"][0.95], t_delay.edge_round_time(tp, A, A_ITERS))


def test_deterministic_delays_need_no_card(probs, monkeypatch):
    """No device is resolved for ``DeterministicDelays``: an int key with
    ``device=None`` works without a card, where a drawing model raises."""
    jp, tp, A = probs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    det = t_st.DeterministicDelays()
    r = t_delay.async_completion(tp, A, A_ITERS, B_ITERS, rounds=4,
                                 max_staleness=1, delay_model=det, key=0)
    r0 = t_delay.async_completion(tp, A, A_ITERS, B_ITERS, rounds=4,
                                  max_staleness=1)
    assert _plain(r["timeline"].trace) == _plain(r0["timeline"].trace)
    t_delay.makespan_distribution(tp, A, A_ITERS, B_ITERS, rounds=3,
                                  max_staleness=1, model=det, num_trials=2)
    urban = t_st.scenario("urban_stragglers").model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_delay.async_completion(tp, A, A_ITERS, B_ITERS, rounds=4,
                                 max_staleness=1, delay_model=urban, key=0)
    with pytest.raises(RuntimeError):
        t_st.ensure_key(0)
    with pytest.raises(RuntimeError):
        t_st.Key(0)
    with pytest.raises(RuntimeError):
        t_assoc.refined(tp, objective="quantile_makespan", num_trials=2,
                        max_moves=1)


# ---------------------------------------------------------------------------
# One injected cycle matrix through both packages: exact
# ---------------------------------------------------------------------------


def _injected(base, mat):
    class Injected(base):
        def cycle_times(self, key, problem, assoc, a, b, num_draws,
                        participation=None, **kw):
            assert num_draws <= len(mat)
            return mat[:num_draws].copy()
    return Injected()


def _matrix(rows, m, seed=0):
    return np.random.default_rng(seed).uniform(0.5, 3.0, (rows, m))


def _plain(trace):
    return [(kind, dataclasses.astuple(ev)) for kind, ev in trace]


@pytest.mark.parametrize("max_staleness", [0, 2])
def test_async_completion_on_injected_matrix_event_for_event(probs,
                                                             max_staleness):
    jp, tp, A = probs
    mat = _matrix(16, jp.num_edges)
    kw = dict(rounds=6, max_staleness=max_staleness)
    tr = t_delay.async_completion(tp, A, A_ITERS, B_ITERS,
                                  delay_model=_injected(t_st.DelayModel, mat),
                                  **kw)
    jr = j_delay.async_completion(jp, A, A_ITERS, B_ITERS,
                                  delay_model=_injected(j_st.DelayModel, mat),
                                  **kw)
    assert _plain(tr["timeline"].trace) == _plain(jr["timeline"].trace)
    for key in ("makespan", "sync_makespan", "speedup", "cloud_idle_frac",
                "arrivals"):
        assert tr[key] == jr[key], key
    np.testing.assert_array_equal(tr["edge_busy_frac"], jr["edge_busy_frac"])
    np.testing.assert_array_equal(tr["active_edges"], jr["active_edges"])


def test_async_completion_with_cohort_masks_equals_reference(probs):
    """A mask without a model takes ``DeterministicDelays``, exactly."""
    jp, tp, A = probs
    part = _masks("per_draw", 7, jp.num_ues, seed=3)
    part[0] = True
    kw = dict(rounds=5, max_staleness=2, participation=part)
    tr = t_delay.async_completion(tp, A, A_ITERS, B_ITERS, **kw)
    jr = j_delay.async_completion(jp, A, A_ITERS, B_ITERS, **kw)
    assert _plain(tr["timeline"].trace) == _plain(jr["timeline"].trace)
    assert tr["sync_makespan"] == jr["sync_makespan"]


def test_makespan_distribution_and_crn_on_injected_matrix(probs):
    jp, tp, A = probs
    trials, rounds, s = 12, 5, 2
    mat = _matrix(trials * (rounds + s), jp.num_edges, seed=4)
    kw = dict(rounds=rounds, max_staleness=s, num_trials=trials)
    td = t_delay.makespan_distribution(
        tp, A, A_ITERS, B_ITERS, model=_injected(t_st.DelayModel, mat), **kw)
    jd = j_delay.makespan_distribution(
        jp, A, A_ITERS, B_ITERS, model=_injected(j_st.DelayModel, mat), **kw)
    assert td.keys() == jd.keys()
    for key in jd:
        np.testing.assert_array_equal(td[key], jd[key])
    cube = mat.reshape(trials, rounds + s, -1)
    np.testing.assert_array_equal(
        t_delay.crn_async_makespans(cube, rounds=rounds, max_staleness=s),
        j_delay.crn_async_makespans(cube, rounds=rounds, max_staleness=s))
    assert t_delay.quantile_makespan(
        tp, A, A_ITERS, B_ITERS, model=_injected(t_st.DelayModel, mat),
        q=0.9, **kw) == j_delay.quantile_makespan(
        jp, A, A_ITERS, B_ITERS, model=_injected(j_st.DelayModel, mat),
        q=0.9, **kw)


# ---------------------------------------------------------------------------
# HFLSimulator(delay_model=)
# ---------------------------------------------------------------------------

SIM_PROBLEM = dict(num_edges=2, num_ues=8, epsilon=0.25, seed=0,
                   samples_lo=50, samples_hi=120)


def _j_loss(p, b):
    return j_lenet.logreg_loss(p, b, l2=1e-3)


def _t_loss(p, b):
    return t_lenet.logreg_loss(p, b, l2=1e-3)


@pytest.fixture(scope="module")
def logreg():
    """``tests/test_torch_async.py``'s logreg setup, for both packages."""
    jsch = j_plan(JProblem(**SIM_PROBLEM))
    tsch = t_plan(TProblem(**SIM_PROBLEM))
    train = synthetic.logreg_data(seed=0, n=800, dim=12, num_classes=4)
    test = synthetic.logreg_data(seed=1, n=200, dim=12, num_classes=4)
    parts = partition.size_partition(np.random.default_rng(0), 800,
                                     tsch.problem.samples.astype(int))
    ue_data = [{k: train[k][ix] for k in train} for ix in parts]
    init = jax.tree.map(np.asarray,
                        j_lenet.logreg_init(jax.random.PRNGKey(0), 12, 4))
    return jsch, tsch, init, ue_data, test


def _tsim(setup, **kw):
    _, tsch, init, ue_data, _ = setup
    return HFLSimulator(tsch, _t_loss, from_jax_params(init, device="cpu"),
                        ue_data, lr=0.02, device="cpu", **kw)


def _leaves(params):
    if isinstance(next(iter(params.values())), torch.Tensor):
        return [x.numpy() for x in tree_leaves(params)]
    return [np.asarray(x) for x in jax.tree.leaves(params)]


def _assert_close(tres, jres, atol):
    np.testing.assert_array_equal(tres.times, jres.times)
    for name in ("test_acc", "test_loss", "train_loss"):
        np.testing.assert_allclose(getattr(tres, name), getattr(jres, name),
                                   atol=atol)
    for t, j in zip(_leaves(tres.final_params), _leaves(jres.final_params)):
        np.testing.assert_allclose(t, j, atol=atol, rtol=0)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_simulator_injected_clock_matches_reference(logreg, mode):
    jsch, _, init, ue_data, test = logreg
    mat = _matrix(8, jsch.num_edges, seed=5)
    kw = dict(mode=mode, max_staleness=2 if mode == "async" else 0)
    jres = JSim(jsch, _j_loss, init, ue_data, lr=0.02,
                delay_model=_injected(j_st.DelayModel, mat), **kw
                ).run(test, rounds=4)
    tres = _tsim(logreg, delay_model=_injected(t_st.DelayModel, mat),
                 **kw).run(test, rounds=4)
    _assert_close(tres, jres, 1e-5)
    if mode == "async":
        assert _plain(tres.timeline.trace) == _plain(jres.timeline.trace)
    else:
        np.testing.assert_array_equal(tres.times,
                                      np.cumsum(mat[:4].max(axis=1)))


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_simulator_lenet_injected_clock_matches_reference(mode):
    """SMOKE-width LeNet, a=5, b=3, one round's quota: params within 1e-4
    of their largest magnitude (``tests/test_torch_async.py``'s rule)."""
    jsch = j_plan(JProblem(**SIM_PROBLEM))
    tsch = t_plan(TProblem(**SIM_PROBLEM))
    jsch = dataclasses.replace(jsch, a=5, b=3)
    tsch = dataclasses.replace(tsch, a=5, b=3)
    train, test = synthetic.synthetic_mnist(seed=0, n_train=400, n_test=64)
    parts = partition.size_partition(np.random.default_rng(0), 400,
                                     tsch.problem.samples.astype(int))
    ue_data = [{k: train[k][ix] for k in train} for ix in parts]
    init = jax.tree.map(np.asarray, jax.jit(
        lambda k: j_lenet.lenet_init(k, J_SMOKE))(jax.random.PRNGKey(0)))
    mat = _matrix(4, jsch.num_edges, seed=6)
    kw = dict(lr=0.05, samples_per_ue=8, mode=mode,
              max_staleness=2 if mode == "async" else 0)
    jres = JSim(jsch, j_lenet.lenet_loss, init, ue_data,
                delay_model=_injected(j_st.DelayModel, mat), **kw
                ).run(test, rounds=1)
    tres = HFLSimulator(tsch, t_lenet.lenet_loss,
                        from_jax_params(init, device="cpu"), ue_data,
                        device="cpu", delay_model=_injected(t_st.DelayModel,
                                                            mat),
                        **kw).run(test, rounds=1)
    np.testing.assert_array_equal(tres.times, jres.times)
    if mode == "async":
        assert _plain(tres.timeline.trace) == _plain(jres.timeline.trace)
    jp, tp = _leaves(jres.final_params), _leaves(tres.final_params)
    scale = max(float(np.abs(x).max()) for x in jp)
    assert max(float(np.abs(t - j).max()) for t, j in zip(tp, jp)) <= \
        1e-4 * scale


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_deterministic_model_is_byte_identical_to_none(logreg, mode):
    test = logreg[4]
    kw = dict(mode=mode, max_staleness=2 if mode == "async" else 0)
    base = _tsim(logreg, **kw).run(test, rounds=3)
    det = _tsim(logreg, delay_model=t_st.DeterministicDelays(),
                delay_seed=9, **kw).run(test, rounds=3)
    assert base.times.tobytes() == det.times.tobytes()
    for name in ("test_acc", "test_loss", "train_loss"):
        assert getattr(base, name).tobytes() == getattr(det, name).tobytes()
    for a, b in zip(_leaves(base.final_params), _leaves(det.final_params)):
        assert a.tobytes() == b.tobytes()


def test_simulator_own_draws_are_keyed_by_delay_seed(logreg):
    """Sync round r costs the max over edges of row r of the model's
    cycle matrix under ``Key(delay_seed)`` on the simulator's device."""
    _, tsch, _, _, test = logreg
    model = t_st.scenario("urban_stragglers").model
    r1 = _tsim(logreg, delay_model=model, delay_seed=3).run(test, rounds=3)
    r2 = _tsim(logreg, delay_model=model, delay_seed=3).run(test, rounds=3)
    r3 = _tsim(logreg, delay_model=model, delay_seed=4).run(test, rounds=3)
    np.testing.assert_array_equal(r1.times, r2.times)
    assert not np.array_equal(r1.times, r3.times)
    rows = model.cycle_times(t_st.Key(3, device="cpu"), tsch.problem,
                             tsch.assoc, tsch.a, tsch.b, 3)
    np.testing.assert_array_equal(r1.times, np.cumsum(rows.max(axis=1)))
    ra = _tsim(logreg, delay_model=model, delay_seed=3, mode="async",
               max_staleness=2).run(test, rounds=3)
    st = t_delay.async_completion(
        tsch.problem, tsch.assoc, tsch.a, tsch.b, rounds=3, max_staleness=2,
        delay_model=model, key=3, device="cpu")
    assert _plain(ra.timeline.trace) == _plain(st["timeline"].trace)


def test_simulator_delay_model_needs_problem(logreg):
    jsch, tsch, init, ue_data, _ = logreg
    model = t_st.scenario("urban_stragglers").model
    with pytest.raises(ValueError, match="problem"):
        HFLSimulator(dataclasses.replace(tsch, problem=None), _t_loss,
                     from_jax_params(init, device="cpu"), ue_data,
                     device="cpu", delay_model=model)
    with pytest.raises(ValueError, match="problem"):
        JSim(dataclasses.replace(jsch, problem=None), _j_loss, init, ue_data,
             delay_model=j_st.scenario("urban_stragglers").model)


# ---------------------------------------------------------------------------
# The port's own draws
# ---------------------------------------------------------------------------


def test_key_protocol():
    k = t_st.Key(0, device="cpu")
    kids = [k, *k.split(), k.fold_in(0), k.fold_in(1),
            k.split()[0].split()[0], k.fold_in(0).split()[0],
            t_st.Key(1, device="cpu")]
    draws = [x.normal((64,)) for x in kids]
    assert all(d.dtype == torch.float32 and d.device.type == "cpu"
               for d in draws)
    for i in range(len(draws)):
        for j in range(i):
            assert not torch.equal(draws[i], draws[j]), (kids[i], kids[j])
    assert torch.equal(k.exponential((8,)), k.exponential((8,)))
    u = k.uniform((4096,), minval=2.0, maxval=3.0)
    assert float(u.min()) >= 2.0 and float(u.max()) < 3.0
    assert t_st.ensure_key(k) is k
    assert t_st.ensure_key(np.int64(5), device="cpu").seed == 5
    assert t_st.Key(-1, device="cpu").normal((2,)).shape == (2,)


def test_own_draws_same_seed_same_rows(probs):
    _, tp, A = probs
    model = t_st.scenario("urban_stragglers").model
    d1 = t_st.sample_cycle_times(model, 7, tp, A, A_ITERS, B_ITERS, 16,
                                 device="cpu")
    d2 = t_st.sample_cycle_times(model, 7, tp, A, A_ITERS, B_ITERS, 16,
                                 device="cpu")
    d3 = t_st.sample_cycle_times(model, 8, tp, A, A_ITERS, B_ITERS, 16,
                                 device="cpu")
    np.testing.assert_array_equal(d1, d2)
    assert not np.array_equal(d1, d3)
    assert d1.dtype == np.float64 and (d1 > 0).all()
    r1 = t_delay.async_completion(tp, A, A_ITERS, B_ITERS, rounds=5,
                                  max_staleness=2, delay_model=model, key=7,
                                  device="cpu")
    r2 = t_delay.async_completion(tp, A, A_ITERS, B_ITERS, rounds=5,
                                  max_staleness=2, delay_model=model,
                                  key=t_st.Key(7, device="cpu"))
    assert r1["timeline"].trace == r2["timeline"].trace


def test_cycle_time_sources_agree_in_any_order(probs):
    _, tp, A = probs
    model = t_st.scenario("flaky_uplink").model
    s1 = t_st.CycleTimeSource(model, 4, tp, A, A_ITERS, B_ITERS,
                              device="cpu")
    s2 = t_st.CycleTimeSource(model, 4, tp, A, A_ITERS, B_ITERS,
                              device="cpu")
    order = [70, 3, 33, 0, 64, 31, 32]
    first = {c: s1.row(c) for c in order}
    for c in reversed(order):
        np.testing.assert_array_equal(s2.row(c), first[c])
    np.testing.assert_array_equal(
        first[33], t_st.cycle_times_chunk(model, 4, tp, A, A_ITERS, B_ITERS,
                                          1, device="cpu")[1])
    assert not np.array_equal(first[0], first[32])


@pytest.mark.parametrize("name", sorted(j_st.SCENARIOS))
def test_own_draws_moments_match_reference(probs, name):
    """Per edge, the mean and the mean square of 4,096 cycle draws lie
    within 4 standard errors of the reference's."""
    jp, tp, A = probs
    jm, tm = _models(name)
    n = 4096
    t = tm.cycle_times(t_st.Key(0, device="cpu"), tp, A, A_ITERS, B_ITERS, n)
    j = jm.cycle_times(0, jp, A, A_ITERS, B_ITERS, n)
    for f in (lambda x: x, np.square):
        ft, fj = f(t), f(j)
        se = np.sqrt(ft.var(0) / n + fj.var(0) / n)
        assert (np.abs(ft.mean(0) - fj.mean(0)) <= 4 * se + 1e-12 *
                np.abs(fj.mean(0))).all(), name


def test_refined_quantile_beats_proposed_and_greedy_on_p95():
    """``tests/test_core_stochastic.py``'s robust-association case on the
    port's own draws."""
    rob = TProblem(num_edges=3, num_ues=12, seed=0, cycles_per_sample_lo=1e3,
                   cycles_per_sample_hi=3e5)
    a, b, rounds, s_max = 8, 3, 6, 2
    model = t_st.scenario("urban_stragglers").model
    kw = dict(rounds=rounds, max_staleness=s_max, model=model, key=0,
              num_trials=12, q=0.95, device="cpu")
    base = t_delay.quantile_makespan(rob, t_assoc.proposed(rob), a, b, **kw)
    greedy = t_delay.quantile_makespan(rob, t_assoc.greedy(rob), a, b, **kw)
    A_rob = t_assoc.refined(rob, a=a, objective="quantile_makespan", b=b,
                            rounds=rounds, max_staleness=s_max,
                            num_trials=12, max_moves=5, delay_key=0,
                            device="cpu")
    tuned = t_delay.quantile_makespan(rob, A_rob, a, b, **kw)
    assert tuned <= base + 1e-9
    assert tuned <= greedy + 1e-9
    assert (A_rob.sum(1) == 1).all()


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------


def test_scenario_registry_matches_reference():
    assert list(t_st.SCENARIOS) == list(j_st.SCENARIOS)
    assert t_core.SCENARIOS is t_st.SCENARIOS
    for name, js in j_st.SCENARIOS.items():
        ts = t_core.scenario(name)
        assert (ts.name, ts.regime, ts.description) == \
            (js.name, js.regime, js.description)
        assert type(ts.model).__name__ == type(js.model).__name__
        assert dataclasses.asdict(ts.model) == dataclasses.asdict(js.model)
        if js.faults is None:
            assert ts.faults is None
        else:
            assert type(ts.faults).__name__ == type(js.faults).__name__
            assert dataclasses.asdict(ts.faults) == \
                dataclasses.asdict(js.faults)
            assert ts.faults.is_null() == js.faults.is_null()
    with pytest.raises(ValueError, match="urban_stragglers"):
        t_core.scenario("nope")
    assert isinstance(t_core.DeterministicDelays(), t_core.DelayModel)
    assert t_core.Scenario is t_st.Scenario
