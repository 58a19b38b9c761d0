"""The port's stochastic joint optimizer (``repro_torch.core.jointopt``,
``schedule.plan_joint``, ``assoc.refined(objective="joint")``) against the
JAX package's.

* ``optimize_bandwidth`` and ``uplink_rescale`` are numpy in both
  packages: equal exactly.
* Under ``DeterministicDelays`` ``solve_joint`` equals the reference
  exactly (tuple, objective, split, history) and returns
  ``solve_direct``'s (a, b) in both packages.
* Fed the reference's own variates (``JaxKey``), ``sample_ingredients``
  equals the reference's draws within rtol 1e-6 (float32 ``exp``/``log2``
  may differ by an ulp between torch and XLA); ``solve_joint``,
  ``plan_joint`` and ``refined(objective="joint")`` choose what the
  reference chooses, with every history objective within rtol 1e-6.  The
  cases were picked with no near-tie at the top of the ranking (checked
  in each test): the rank compares float64 objectives built from float32
  draws, so a near-tie could flip on an ulp.
* ``plan_joint``'s staleness bound reaches ``HFLSimulator(max_staleness=
  None)``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _jax_key import JaxKey  # noqa: E402

from repro.core import assoc as j_assoc  # noqa: E402
from repro.core import iteropt as j_iteropt  # noqa: E402
from repro.core import jointopt as j_jo  # noqa: E402
from repro.core import schedule as j_schedule  # noqa: E402
from repro.core import stochastic as j_st  # noqa: E402
from repro.core.problem import HFLProblem as JProblem  # noqa: E402
from repro_torch.core import assoc as t_assoc  # noqa: E402
from repro_torch.core import iteropt as t_iteropt  # noqa: E402
from repro_torch.core import jointopt as t_jo  # noqa: E402
from repro_torch.core import schedule as t_schedule  # noqa: E402
from repro_torch.core import stochastic as t_st  # noqa: E402
from repro_torch.core.problem import HFLProblem as TProblem  # noqa: E402
from repro_torch.data import partition, synthetic  # noqa: E402
from repro_torch.fl.sim import HFLSimulator  # noqa: E402
from repro_torch.models import lenet as t_lenet  # noqa: E402

RTOL = 1e-6
# README's joint example and phase 3's problem
SMALL = dict(num_edges=3, num_ues=12, seed=0)
PROBLEMS = {"small": SMALL,
            "paper": dict(num_edges=5, num_ues=100, epsilon=0.25, seed=0)}
# The README's search settings, cut to keep the reference's draws quick.
SEARCH = dict(num_trials=8, rounds_cap=12, staleness_grid=(0, 1, 2))
NEAR_TIE = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small operations gain nothing from more,
    and idle threads spinning would slow the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _probs(name):
    kw = PROBLEMS[name]
    jp, tp = JProblem(**kw), TProblem(**kw)
    A = j_assoc.proposed(jp)
    np.testing.assert_array_equal(A, t_assoc.proposed(tp))
    return jp, tp, A


def _no_near_tie(history):
    """The best objective is alone: the runner-up (other than exact ties,
    which the tuple rank breaks the same way in both packages) lies more
    than NEAR_TIE relative above it."""
    objs = sorted({h[-1] for h in history if np.isfinite(h[-1])})
    assert len(objs) > 1
    assert objs[1] - objs[0] > NEAR_TIE * objs[0], objs[:2]


# ---------------------------------------------------------------------------
# numpy: exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PROBLEMS))
@pytest.mark.parametrize("a", [1, 8, 30])
def test_bandwidth_split_and_rescale_equal_reference(name, a):
    jp, tp, A = _probs(name)
    jf = j_jo.optimize_bandwidth(jp, A, a)
    tf = t_jo.optimize_bandwidth(tp, A, a)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(t_jo.uplink_rescale(tp, A, tf),
                                  j_jo.uplink_rescale(jp, A, jf))
    # each cell's split sums to 1
    gid = A.argmax(1)
    for m in range(A.shape[1]):
        assert tf[gid == m].sum() == pytest.approx(1.0)


def test_bandwidth_split_with_an_empty_cell_and_an_orphan():
    jp, tp, A = _probs("small")
    A = A.copy()
    A[:, 2] = 0                  # an empty cell
    A[0] = 0                     # an unassociated UE
    A[A.sum(1) == 0, 0] = 1
    A[0] = 0
    tf = t_jo.optimize_bandwidth(tp, A, 8)
    np.testing.assert_array_equal(tf, j_jo.optimize_bandwidth(jp, A, 8))
    assert tf[0] == 0.0


@pytest.mark.parametrize("a,b", [(1, 1), (8, 9), (3, 40)])
def test_candidate_rounds_equal_reference(a, b):
    jp, tp, _ = _probs("paper")
    assert t_jo.candidate_rounds(tp, a, b) == j_jo.candidate_rounds(jp, a, b)


def test_scaled_grid_equals_reference():
    for v in (1, 2, 7, 13):
        assert t_jo._scaled_grid(v) == j_jo._scaled_grid(v)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_deterministic_solve_joint_equals_reference_and_solve_direct(name):
    jp, tp, A = _probs(name)
    js = j_jo.solve_joint(jp, A, model="deterministic", **SEARCH)
    ts = t_jo.solve_joint(tp, A, model="deterministic", **SEARCH)
    for sol, det in ((js, j_iteropt.solve_direct(jp, A)),
                     (ts, t_iteropt.solve_direct(tp, A))):
        assert (sol.a, sol.b) == (det.a_int, det.b_int)
    for f in ("a", "b", "max_staleness", "objective", "rounds", "q",
              "bandwidth"):
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.history == js.history
    if js.bandwidth_frac is None:
        assert ts.bandwidth_frac is None
    else:
        np.testing.assert_array_equal(ts.bandwidth_frac, js.bandwidth_frac)


def test_deterministic_draws_need_no_card(monkeypatch):
    """``DeterministicDelays`` never resolves a device; an int key under a
    drawing model with ``device=None`` raises without a card."""
    _, tp, A = _probs("small")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = t_jo.sample_ingredients(t_st.DeterministicDelays(), 0, tp, A,
                                num_trials=2, cycles=3, b_max=4)
    assert d.compute.dtype == np.float64
    np.testing.assert_array_equal(d.compute[1, 2, 3], tp.t_cmp())
    t_schedule.plan_joint(tp, scenario="deterministic", **SEARCH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_jo.sample_ingredients(t_st.scenario("urban_stragglers").model, 0,
                                tp, A, num_trials=2, cycles=3, b_max=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_jo.solve_joint(tp, A, **SEARCH)


# ---------------------------------------------------------------------------
# The reference's variates through the port: rtol 1e-6, the same choice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scenario", ["urban_stragglers", "flaky_uplink",
                                      "heavy_tail_compute"])
def test_sample_ingredients_match_reference_on_its_variates(scenario):
    jp, tp, A = _probs("small")
    kw = dict(num_trials=3, cycles=5, b_max=4)
    jd = j_jo.sample_ingredients(j_st.scenario(scenario).model, 7, jp, A,
                                 **kw)
    td = t_jo.sample_ingredients(t_st.scenario(scenario).model, JaxKey(7),
                                 tp, A, **kw)
    for f in ("compute", "uplink", "backhaul"):
        got, want = getattr(td, f), getattr(jd, f)
        assert got.dtype == np.float64 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=RTOL)
    for f in ("active", "active_idx"):
        np.testing.assert_array_equal(getattr(td, f), getattr(jd, f))
    np.testing.assert_allclose(td.cycle_times(8, 3), jd.cycle_times(8, 3),
                               rtol=RTOL)
    scale = t_jo.uplink_rescale(tp, A, t_jo.optimize_bandwidth(tp, A, 8))
    np.testing.assert_allclose(td.cycle_times(8, 4, scale),
                               jd.cycle_times(8, 4, scale), rtol=RTOL)


def test_evaluate_tuple_on_shared_draws_equals_reference():
    """Given the same draws, scoring is numpy in both packages: exact."""
    jp, tp, A = _probs("small")
    jd = j_jo.sample_ingredients(j_st.scenario("urban_stragglers").model, 3,
                                 jp, A, num_trials=4, cycles=14, b_max=9)
    for a, b, s in ((8, 9, 0), (4, 5, 2), (12, 9, 1)):
        jo, jms = j_jo.evaluate_tuple(jp, A, a, b, s, draws=jd,
                                      rounds_cap=12, return_makespans=True)
        to, tms = t_jo.evaluate_tuple(tp, A, a, b, s, draws=jd,
                                      rounds_cap=12, return_makespans=True)
        assert to == jo
        np.testing.assert_array_equal(tms, jms)


@pytest.mark.parametrize("name,scenario", [("small", "urban_stragglers"),
                                           ("paper", "urban_stragglers"),
                                           ("small", "flaky_uplink")])
def test_solve_joint_matches_reference_on_its_variates(name, scenario):
    jp, tp, A = _probs(name)
    js = j_jo.solve_joint(jp, A, model=scenario, key=0, **SEARCH)
    ts = t_jo.solve_joint(tp, A, model=scenario, key=JaxKey(0), **SEARCH)
    _no_near_tie(js.history)
    assert ((ts.a, ts.b, ts.max_staleness, ts.bandwidth) ==
            (js.a, js.b, js.max_staleness, js.bandwidth))
    assert ts.rounds == js.rounds
    assert [h[:4] for h in ts.history] == [h[:4] for h in js.history]
    np.testing.assert_allclose([h[4] for h in ts.history],
                               [h[4] for h in js.history], rtol=RTOL)
    if js.bandwidth_frac is not None:
        np.testing.assert_array_equal(ts.bandwidth_frac, js.bandwidth_frac)


def test_plan_joint_matches_reference_and_drives_the_simulator():
    kw = PROBLEMS["small"]
    jp, tp = JProblem(**kw), TProblem(**kw)
    js = j_schedule.plan_joint(jp, key=0, **SEARCH)
    ts = t_schedule.plan_joint(tp, key=JaxKey(0), **SEARCH)
    assert (ts.a, ts.b, ts.rounds) == (js.a, js.b, js.rounds)
    np.testing.assert_array_equal(ts.assoc, js.assoc)
    for k in ("association", "solver", "scenario", "max_staleness",
              "objective_q", "bandwidth"):
        assert ts.meta[k] == js.meta[k], k
    assert ts.meta["objective"] == pytest.approx(js.meta["objective"],
                                                 rel=RTOL)
    # the winning split is applied to the problem, as in the reference
    if jp.bandwidth_frac is None:
        assert tp.bandwidth_frac is None
    else:
        np.testing.assert_array_equal(tp.bandwidth_frac, jp.bandwidth_frac)
    assert ts.total_delay == js.total_delay
    np.testing.assert_array_equal(ts.edge_round_time, js.edge_round_time)

    n = int(tp.samples.sum())
    train = synthetic.logreg_data(seed=0, n=n, dim=12, num_classes=4)
    parts = partition.size_partition(np.random.default_rng(0), n,
                                     tp.samples.astype(int))
    sim = HFLSimulator(ts, lambda p, b: t_lenet.logreg_loss(p, b),
                       t_lenet.logreg_init(12, 4, device="cpu"),
                       [{k: train[k][ix] for k in train} for ix in parts],
                       mode="async", max_staleness=None, device="cpu")
    assert sim.max_staleness == ts.meta["max_staleness"]


def test_refined_joint_matches_reference_on_its_variates():
    """The README's 12-UE, 3-edge problem: the descent over the
    reference's draws, with the split re-optimised per candidate, picks
    the reference's association and leaves the problem's split alone."""
    kw = dict(num_edges=3, num_ues=12, seed=0, cycles_per_sample_lo=1e3,
              cycles_per_sample_hi=3e5)
    jp, tp = JProblem(**kw), TProblem(**kw)
    args = dict(a=8, objective="joint", b=3, rounds=6, max_staleness=2,
                num_trials=12, max_moves=5)
    tA = t_assoc.refined(tp, delay_key=JaxKey(0), **args)
    np.testing.assert_array_equal(tA, j_assoc.refined(jp, delay_key=0,
                                                      **args))
    assert tp.bandwidth_frac is None
    assert (tA.sum(1) == 1).all()
    # the joint objective scores a re-split: it differs from the quantile
    # objective's score at the same association
    t_um = t_st.scenario("urban_stragglers").model
    from repro_torch.core import delay as t_delay
    q_eq = t_delay.quantile_makespan(tp, tA, 8, 3, rounds=6,
                                     max_staleness=2, model=t_um,
                                     key=JaxKey(0), num_trials=12)
    tp.bandwidth_frac = t_jo.optimize_bandwidth(tp, tA, 8)
    q_bw = t_delay.quantile_makespan(tp, tA, 8, 3, rounds=6,
                                     max_staleness=2, model=t_um,
                                     key=JaxKey(0), num_trials=12)
    assert q_bw != q_eq


# ---------------------------------------------------------------------------
# The port's own draws
# ---------------------------------------------------------------------------


def test_own_draws_are_keyed_and_reused_across_candidates():
    _, tp, A = _probs("small")
    um = t_st.scenario("urban_stragglers").model
    d1 = t_jo.sample_ingredients(um, 5, tp, A, num_trials=2, cycles=4,
                                 b_max=3, device="cpu")
    d2 = t_jo.sample_ingredients(um, t_st.Key(5, device="cpu"), tp, A,
                                 num_trials=2, cycles=4, b_max=3)
    d3 = t_jo.sample_ingredients(um, 6, tp, A, num_trials=2, cycles=4,
                                 b_max=3, device="cpu")
    np.testing.assert_array_equal(d1.uplink, d2.uplink)
    assert not np.array_equal(d1.uplink, d3.uplink)
    # at b == b_max the flat draw order is the model's cycle_times'
    rows = um.cycle_times(t_st.Key(5, device="cpu"), tp, A, 8, 3, 8)
    np.testing.assert_allclose(d1.cycle_times(8, 3).reshape(8, -1), rows,
                               rtol=RTOL)
    s1 = t_jo.solve_joint(tp, A, key=5, device="cpu", **SEARCH)
    s2 = t_jo.solve_joint(tp, A, key=5, device="cpu", **SEARCH)
    assert s1.history == s2.history


def test_solve_joint_validation():
    _, tp, A = _probs("small")
    with pytest.raises(ValueError, match="staleness_grid"):
        t_jo.solve_joint(tp, A, model="deterministic", staleness_grid=(-1,))
    with pytest.raises(ValueError, match="b="):
        t_jo.sample_ingredients(t_st.DeterministicDelays(), 0, tp, A,
                                num_trials=1, cycles=2,
                                b_max=2).cycle_times(8, 3)
    with pytest.raises(ValueError, match="num_trials"):
        t_jo.sample_ingredients(t_st.DeterministicDelays(), 0, tp, A,
                                num_trials=0, cycles=2, b_max=2)
    small = t_jo.sample_ingredients(t_st.DeterministicDelays(), 0, tp, A,
                                    num_trials=1, cycles=2, b_max=2)
    with pytest.raises(ValueError, match="too small"):
        t_jo.solve_joint(tp, A, model="deterministic", draws=small)


@pytest.mark.cuda
def test_draws_on_the_card_equal_the_cpu():
    """Device placement: a seed gives the same rows on the card as on the
    CPU (the variates come from CPU generators), and the choice agrees."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, tp, A = _probs("paper")
    um = t_st.scenario("urban_stragglers").model
    kw = dict(num_trials=4, cycles=6, b_max=5)
    dc = t_jo.sample_ingredients(um, 0, tp, A, device="cuda", **kw)
    dh = t_jo.sample_ingredients(um, 0, tp, A, device="cpu", **kw)
    np.testing.assert_allclose(dc.uplink, dh.uplink, rtol=RTOL)
    sc = t_jo.solve_joint(tp, A, key=0, device="cuda", **SEARCH)
    sh = t_jo.solve_joint(tp, A, key=0, device="cpu", **SEARCH)
    assert (sc.a, sc.b, sc.max_staleness, sc.bandwidth) == \
        (sh.a, sh.b, sh.max_staleness, sh.bandwidth)
