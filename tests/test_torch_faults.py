"""The port's fault handling (``repro_torch.core.faults``' policy,
``faulty_cycle_stats`` and ``FaultCycleSource``; ``assoc.orphans_of`` and
``assoc.failover``; ``delay.faulty_async_completion`` and
``delay.fault_makespan_distribution``) against the JAX package's.

Fed the reference's own variates through the port's key protocol
(``JaxKey``): survivor masks, ``down`` and outage windows equal the
reference's exactly, and cycle times, delivered fractions and stalls lie
within rtol 1e-6 (float32 ``log``/``exp2`` may differ by an ulp between
torch and XLA).  The association is numpy in both packages and must be
equal.  The event traces of the fault-aware makespans are equal, event
for event, and the makespans within rtol 1e-6.  The reference's own
properties (CRN ordering, null model, over-selection) hold for the
port's own draws.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _jax_key import JaxKey  # noqa: E402

from repro.core import assoc as j_assoc  # noqa: E402
from repro.core import delay as j_delay  # noqa: E402
from repro.core import faults as j_f  # noqa: E402
from repro.core import stochastic as j_st  # noqa: E402
from repro.core.problem import HFLProblem as JProblem  # noqa: E402
from repro_torch import core as t_core  # noqa: E402
from repro_torch.core import assoc as t_assoc  # noqa: E402
from repro_torch.core import delay as t_delay  # noqa: E402
from repro_torch.core import faults as t_f  # noqa: E402
from repro_torch.core import stochastic as t_st  # noqa: E402
from repro_torch.core.problem import HFLProblem as TProblem  # noqa: E402

RTOL = 1e-6
CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small operations gain nothing from more,
    and idle threads spinning would slow the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# The fault processes of tests/test_core_faults.py, alone and composed.
PROCESSES = {
    "none": {},
    "bernoulli": dict(dropout=("BernoulliDropout", (0.4,))),
    "churn_loss": dict(dropout=("MarkovChurn", (0.2, 0.4)),
                       loss=("UplinkLoss", (0.3,))),
    "loss_0.6": dict(loss=("UplinkLoss", (0.6,))),
    "outage": dict(outage=("EdgeOutage", (0.3, 2.0))),
    "all": dict(dropout=("BernoulliDropout", (0.4,)),
                loss=("UplinkLoss", (0.3,)),
                outage=("EdgeOutage", (0.1, 2.0))),
}
POLICIES = {
    "wait_for_all": lambda f: f.wait_for_all_policy(),
    "deadline_failover": lambda f: f.deadline_failover_policy(),
    "default": lambda f: f.FaultPolicy(),
    "bare_deadline": lambda f: f.FaultPolicy(
        name=f.DEADLINE_FAILOVER, deadline_factor=1.01, max_retries=9),
    "floored_deadline": lambda f: f.FaultPolicy(
        name=f.DEADLINE_FAILOVER, deadline_factor=1.01, max_retries=9,
        min_deliver_frac=0.7),
}


def _fm(f, name):
    return f.FaultModel(**{k: getattr(f, cls)(*args)
                           for k, (cls, args) in PROCESSES[name].items()})


@pytest.fixture(scope="module")
def probs():
    kw = dict(num_edges=3, num_ues=12, seed=0)
    jp, tp = JProblem(**kw), TProblem(**kw)
    return jp, tp, j_assoc.proposed(jp)


def _assert_stats_equal(t, j):
    assert isinstance(t, t_f.FaultyCycles)
    np.testing.assert_array_equal(t.survivors, np.asarray(j.survivors))
    np.testing.assert_array_equal(t.down, np.asarray(j.down))
    assert t.windows == j.windows
    for name in ("cycle_times", "delivered_frac", "stall"):
        tv, jv = getattr(t, name), np.asarray(getattr(j, name))
        assert tv.shape == jv.shape and tv.dtype == jv.dtype, name
        np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=0, err_msg=name)


def test_policy_constructors_and_validation_as_reference():
    for build in (lambda f: f.FaultPolicy(),
                  lambda f: f.wait_for_all_policy(),
                  lambda f: f.deadline_failover_policy(),
                  lambda f: f.deadline_failover_policy(2.0, 5, 0.1)):
        assert dataclasses.asdict(build(t_f)) == dataclasses.asdict(
            build(j_f))
    for bad in (dict(name="bogus"), dict(deadline_factor=0.0),
                dict(deadline_factor=-1.0), dict(min_deliver_frac=1.5),
                dict(min_deliver_frac=-0.1)):
        with pytest.raises(ValueError):
            t_f.FaultPolicy(**bad)
        with pytest.raises(ValueError):
            j_f.FaultPolicy(**bad)


@pytest.mark.parametrize("model", [None, "ue_churn", "lossy_uplink"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("process", sorted(PROCESSES))
def test_faulty_cycle_stats_equal_reference(probs, process, policy, model):
    jp, tp, A = probs
    jdm = j_st.scenario(model).model if model else None
    tdm = t_st.scenario(model).model if model else None
    j = j_f.faulty_cycle_stats(_fm(j_f, process), POLICIES[policy](j_f), 5,
                               jp, A, 8, 3, 10, delay_model=jdm)
    t = t_f.faulty_cycle_stats(_fm(t_f, process), POLICIES[policy](t_f),
                               JaxKey(5), tp, A, 8, 3, 10, delay_model=tdm)
    _assert_stats_equal(t, j)


def test_deadline_dominated_by_wait_for_all_on_own_draws(probs):
    """Common random numbers on the port's own key: the deadline policy's
    cycle times are pointwise <= wait-for-all's, the naive policy drops
    no one, the deadline policy does, and the draw is keyed."""
    _, tp, A = probs
    fm = t_f.FaultModel(dropout=t_f.MarkovChurn(p_off=0.2, p_on=0.4),
                        loss=t_f.UplinkLoss(rate=0.3))
    key = t_st.Key(5, **CPU)
    wfa = t_f.faulty_cycle_stats(fm, t_f.wait_for_all_policy(), key, tp, A,
                                 8, 3, 10)
    dlf = t_f.faulty_cycle_stats(fm, t_f.deadline_failover_policy(), key,
                                 tp, A, 8, 3, 10)
    assert np.all(dlf.cycle_times <= wfa.cycle_times + 1e-9)
    assert wfa.cycle_times.sum() > dlf.cycle_times.sum()
    assert wfa.survivors.all() and not dlf.survivors.all()
    again = t_f.faulty_cycle_stats(fm, t_f.wait_for_all_policy(), 5, tp, A,
                                   8, 3, 10, **CPU)
    np.testing.assert_array_equal(again.cycle_times, wfa.cycle_times)


def test_null_model_reproduces_plain_draws(probs):
    """All rates zero: the cycle times are the plain sampler's (the
    deterministic constants, or a stochastic model's draws on the same
    ingredient keys), everyone survives, no window."""
    _, tp, A = probs
    fc = t_f.faulty_cycle_stats(t_f.FaultModel(), t_f.wait_for_all_policy(),
                                0, tp, A, 8, 3, 6, **CPU)
    np.testing.assert_allclose(fc.cycle_times, np.tile(
        t_delay.edge_cycle_time(tp, A, 8, 3), (6, 1)), rtol=1e-5)
    assert fc.survivors.all() and not fc.windows and not fc.down.any()
    assert (fc.delivered_frac == 1.0).all() and (fc.stall == 0).all()
    # a stochastic model: the same compute draws as the plain per-UE sum
    model = t_st.scenario("ue_churn").model
    key = t_st.Key(3, **CPU)
    fc = t_f.faulty_cycle_stats(t_f.FaultModel(), t_f.FaultPolicy(), key,
                                tp, A, 8, 3, 6, delay_model=model)
    kc, ku, kb = key.split(6)[:3]
    per_ue = (8.0 * model.sample_compute(kc, tp, 18) +
              model.sample_uplink(ku, tp, A, 18))
    tau = t_st._segment_max(per_ue, A).numpy().reshape(6, 3, -1).sum(1)
    t_mc = model.sample_backhaul(kb, tp, 6).numpy()
    np.testing.assert_allclose(fc.cycle_times, tau + t_mc, rtol=RTOL)


def test_min_deliver_frac_over_selection(probs):
    """Over-selection relaxes a tight deadline per edge round: under the
    same draws the floored policy delivers pointwise at least as much,
    substantially more in aggregate, and its cycles may only grow."""
    _, tp, A = probs
    fm = t_f.FaultModel(loss=t_f.UplinkLoss(rate=0.6))
    key = t_st.Key(7, **CPU)
    fb = t_f.faulty_cycle_stats(fm, POLICIES["bare_deadline"](t_f), key, tp,
                                A, 8, 3, 8)
    ff = t_f.faulty_cycle_stats(fm, POLICIES["floored_deadline"](t_f), key,
                                tp, A, 8, 3, 8)
    assert np.all(ff.delivered_frac >= fb.delivered_frac - 1e-9)
    assert ff.delivered_frac.mean() > fb.delivered_frac.mean() + 0.05
    assert np.all(ff.cycle_times >= fb.cycle_times - 1e-9)


@pytest.mark.parametrize("key_kind", ["jax", "own"])
def test_fault_cycle_source_rows_equal_direct_calls(probs, key_kind):
    """Each chunk is ``faulty_cycle_stats`` at ``fold_in(key, chunk)``
    without outages, byte for byte, whatever the access order."""
    _, tp, A = probs
    key = JaxKey(2) if key_kind == "jax" else t_st.Key(2, **CPU)
    fm = t_f.FaultModel(dropout=t_f.MarkovChurn(0.2, 0.4),
                        loss=t_f.UplinkLoss(0.3),
                        outage=t_f.EdgeOutage(0.3, 2.0))
    pol = t_f.deadline_failover_policy()
    src = t_f.FaultCycleSource(fm, pol, key, tp, A, 8, 3, block=4)
    again = t_f.FaultCycleSource(fm, pol, key, tp, A, 8, 3, block=4)
    for c in (9, 0, 5, 11, 2):
        chunk, off = divmod(c, 4)
        direct = t_f.faulty_cycle_stats(
            dataclasses.replace(fm, outage=None), pol, key.fold_in(chunk),
            tp, A, 8, 3, 4)
        assert src.cycle_row(c).tobytes() == \
            direct.cycle_times[off].tobytes()
        assert src.survivor_row(c).tobytes() == \
            direct.survivors[off].tobytes()
        assert not src.stats(chunk).windows
    for c in range(12):
        assert again.cycle_row(c).tobytes() == src.cycle_row(c).tobytes()
    assert t_f.FaultCycleSource(fm, pol, key, tp, A, 8, 3).block == \
        t_st.CYCLE_BLOCK == j_st.CYCLE_BLOCK
    with pytest.raises(ValueError):
        t_f.FaultCycleSource(fm, pol, key, tp, A, 8, 3, block=0)


def test_fault_cycle_source_equals_reference(probs):
    jp, tp, A = probs
    fm = lambda f: f.FaultModel(dropout=f.BernoulliDropout(0.3),  # noqa
                                loss=f.UplinkLoss(0.3))
    j = j_f.FaultCycleSource(fm(j_f), j_f.deadline_failover_policy(),
                             jax.random.PRNGKey(4), jp, A, 8, 3, block=4)
    t = t_f.FaultCycleSource(fm(t_f), t_f.deadline_failover_policy(),
                             JaxKey(4), tp, A, 8, 3, block=4)
    for c in (0, 3, 6, 13):
        np.testing.assert_allclose(t.cycle_row(c), j.cycle_row(c),
                                   rtol=RTOL)
        np.testing.assert_array_equal(t.survivor_row(c),
                                      np.asarray(j.survivor_row(c)))


# -- association ------------------------------------------------------------


@pytest.mark.parametrize("dead", [[0], [1], [2], [0, 2]])
@pytest.mark.parametrize("a", [8.0, 10.0])
def test_failover_and_orphans_equal_reference(dead, a):
    kw = dict(num_edges=3, num_ues=12, seed=0)
    jp, tp = JProblem(**kw), TProblem(**kw)
    A = j_assoc.proposed(jp)
    np.testing.assert_array_equal(t_assoc.orphans_of(A, dead),
                                  j_assoc.orphans_of(A, dead))
    t = t_assoc.failover(tp, A, dead, a=a)
    np.testing.assert_array_equal(t, j_assoc.failover(jp, A, dead, a=a))
    assert t[:, dead].sum() == 0 and t.sum() == A.sum()
    keep = A[:, dead].sum(1) == 0
    np.testing.assert_array_equal(t[keep], A[keep])


def test_failover_capacity_relaxation_and_errors():
    """A fleet the survivors cannot hold under the cap (the cap relaxes),
    an unassigned row (stays unassigned), no orphans (unchanged), and the
    reference's errors."""
    kw = dict(num_edges=4, num_ues=20, seed=3)
    jp, tp = JProblem(**kw), TProblem(**kw)
    A = j_assoc.proposed(jp).copy()
    A[5] = 0
    for dead in ([1, 2, 3], [0, 3]):
        np.testing.assert_array_equal(t_assoc.failover(tp, A, dead),
                                      j_assoc.failover(jp, A, dead))
        assert t_assoc.failover(tp, A, dead)[5].sum() == 0
    empty = np.zeros_like(A)
    empty[:, :2] = A[:, :2]
    np.testing.assert_array_equal(t_assoc.failover(tp, empty, [3]), empty)
    assert t_assoc.orphans_of(empty, [2, 3]).size == 0
    for dead in ([0, 1, 2, 3], [4], [-1]):
        with pytest.raises(ValueError):
            t_assoc.failover(tp, A, dead)
        with pytest.raises(ValueError):
            j_assoc.failover(jp, A, dead)


# -- fault-aware makespans ----------------------------------------------------


def _assert_trace(t, j):
    """Equal event for event: kinds, edges, cycles, versions and merges
    exactly, times within rtol 1e-6 (the cycle times are)."""
    def parts(trace):
        return [(k, type(e).__name__, {f: v for f, v in
                                        dataclasses.asdict(e).items()
                                        if f != "t"}) for k, e in trace]
    assert parts(t) == parts(j)
    np.testing.assert_allclose([e.t for _, e in t], [e.t for _, e in j],
                               rtol=RTOL)


@pytest.fixture(scope="module")
def fleet():
    kw = dict(num_edges=4, num_ues=24, seed=0)
    jp, tp = JProblem(**kw), TProblem(**kw)
    return jp, tp, j_assoc.proposed(jp)


@pytest.mark.parametrize("policy", ["wait_for_all", "deadline_failover"])
@pytest.mark.parametrize("scen", ["ue_churn", "edge_outage", "lossy_uplink"])
def test_faulty_async_completion_equals_reference(fleet, scen, policy):
    """Each fault scenario (``edge_outage`` at a 30 % rate, so outages and
    failover re-scoring happen) under both policies at max_staleness=1."""
    jp, tp, A = fleet
    js, ts = j_st.scenario(scen), t_st.scenario(scen)
    jfm, tfm = js.faults, ts.faults
    if scen == "edge_outage":
        jfm = j_f.FaultModel(outage=j_f.EdgeOutage(0.3, 2.0))
        tfm = t_f.FaultModel(outage=t_f.EdgeOutage(0.3, 2.0))
    common = dict(rounds=4, max_staleness=1)
    j = j_delay.faulty_async_completion(
        jp, A, 8, 9, fault_model=jfm, policy=POLICIES[policy](j_f),
        delay_model=js.model, key=0, **common)
    t = t_delay.faulty_async_completion(
        tp, A, 8, 9, fault_model=tfm, policy=POLICIES[policy](t_f),
        delay_model=ts.model, key=JaxKey(0), **common)
    _assert_trace(t["timeline"].trace, j["timeline"].trace)
    for name in ("makespan", "sync_makespan", "speedup", "cloud_idle_frac",
                 "edge_busy_frac", "delivered_frac", "survivor_frac"):
        np.testing.assert_allclose(t[name], j[name], rtol=RTOL,
                                   err_msg=name)
    for name in ("num_failures", "num_repairs", "windows"):
        assert t[name] == j[name], name
    np.testing.assert_array_equal(t["active_edges"], j["active_edges"])
    _assert_stats_equal(t["cycle_stats"], j["cycle_stats"])
    if scen == "edge_outage":
        assert t["windows"]
        if policy == "deadline_failover":
            assert t["num_failures"] > 0


def test_fault_makespan_distribution_equals_reference(fleet):
    """8 trials, both policies, on one edge-outage and churn model:
    every trial's makespan within rtol 1e-6 of the reference's."""
    jp, tp, A = fleet
    fm = lambda f: f.FaultModel(  # noqa: E731
        dropout=f.MarkovChurn(0.15, 0.45),
        outage=f.EdgeOutage(0.1, 3.0))
    pols = lambda f: {"wfa": f.wait_for_all_policy(),  # noqa: E731
                      "dlf": f.deadline_failover_policy()}
    common = dict(rounds=4, max_staleness=1, num_trials=8)
    j = j_delay.fault_makespan_distribution(
        jp, A, 8, 9, fault_model=fm(j_f), policies=pols(j_f),
        delay_model=j_st.scenario("ue_churn").model, key=0, **common)
    t = t_delay.fault_makespan_distribution(
        tp, A, 8, 9, fault_model=fm(t_f), policies=pols(t_f),
        delay_model=t_st.scenario("ue_churn").model, key=JaxKey(0),
        **common)
    assert set(t) == set(j)
    for n in ("wfa", "dlf"):
        np.testing.assert_allclose(t["makespans"][n], j["makespans"][n],
                                   rtol=RTOL)
        for s in ("p50", "p95", "delivered_frac"):
            np.testing.assert_allclose(t[f"{n}_{s}"], j[f"{n}_{s}"],
                                       rtol=RTOL)


def test_fault_makespans_on_own_draws(probs):
    """The port's own keys: the null model reproduces the plain async
    timeline event for event (its float32 hooks within rtol 1e-5 of the
    float64 constants, as the reference's test holds it), the deadline
    policy beats wait-for-all at p50 on a long outage, and an int key with
    ``device=`` equals ``Key(seed)``."""
    _, tp, A = probs
    base = t_delay.async_completion(tp, A, 8, 3, rounds=4, max_staleness=1)
    fa = t_delay.faulty_async_completion(
        tp, A, 8, 3, rounds=4, max_staleness=1,
        fault_model=t_f.FaultModel(),
        policy=t_f.deadline_failover_policy(), key=0, **CPU)
    assert np.isclose(fa["makespan"], base["makespan"], rtol=1e-5)
    assert [k for k, _ in fa["timeline"].trace] == \
        [k for k, _ in base["timeline"].trace]
    np.testing.assert_allclose([e.t for _, e in fa["timeline"].trace],
                               [e.t for _, e in base["timeline"].trace],
                               rtol=1e-5)
    fm = t_f.FaultModel(outage=t_f.EdgeOutage(0.05, 6.0))
    pols = {"wfa": t_f.wait_for_all_policy(),
            "dlf": t_f.deadline_failover_policy()}
    d = t_delay.fault_makespan_distribution(
        tp, A, 8, 9, rounds=4, max_staleness=1, fault_model=fm,
        policies=pols, key=0, num_trials=8, **CPU)
    assert d["dlf_p50"] <= d["wfa_p50"]
    again = t_delay.fault_makespan_distribution(
        tp, A, 8, 9, rounds=4, max_staleness=1, fault_model=fm,
        policies=pols, key=t_st.Key(0, **CPU), num_trials=8)
    for n in pols:
        np.testing.assert_array_equal(d["makespans"][n],
                                      again["makespans"][n])


def test_key_gumbel_is_jax_definition():
    """``Key.gumbel`` is ``-log(-log(u))`` over ``uniform(minval=tiny)``:
    run on the reference's uniforms it gives ``jax.random.gumbel``; on its
    own key it is keyed and has the standard Gumbel's mean (Euler's
    gamma) and variance (pi^2/6) within 4 standard errors."""
    k = jax.random.PRNGKey(4)
    t = t_st.Key.gumbel(JaxKey(k), (4096,))
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(
        jax.random.gumbel(k, (4096,))), rtol=1e-6, atol=1e-6)
    own = t_st.Key(9, **CPU)
    g = own.gumbel((20000,)).numpy().astype(np.float64)
    np.testing.assert_array_equal(own.gumbel((20000,)).numpy(),
                                  g.astype(np.float32))
    assert np.isfinite(g).all()
    se = np.sqrt(np.pi ** 2 / 6 / g.size)
    assert abs(g.mean() - np.euler_gamma) <= 4 * se
    assert abs(g.var() - np.pi ** 2 / 6) <= 4 * np.sqrt(
        ((g - g.mean()) ** 4).mean() / g.size)


def test_exports():
    for name in ("FaultModel", "FaultPolicy", "faulty_cycle_stats",
                 "deadline_failover_policy", "wait_for_all_policy"):
        assert getattr(t_core, name) is getattr(t_f, name)
