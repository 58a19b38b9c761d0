"""Delay model — eqs. (1)–(8), the objective of problem (13), and the
BEYOND-PAPER asynchronous completion-time distribution.

All functions are pure numpy over an ``HFLProblem`` instance and an
association matrix ``assoc`` of shape (N, M) with 0/1 entries, one 1 per row.

Objective (eq. 13):

    total(a, b, chi) = R(a,b,eps) * T(a,b,chi)
    T  = max_m { b * tau_m + t_{m->c} }          (eq. 34)
    tau_m = max_{n in N_m} { a * t_cmp_n + t_com_{n->m} }   (eq. 33)

Async extension (``edge_cycle_time`` / ``async_completion``): drop eq. 34's
outer max (the cloud barrier) and let each edge repeat its own cycle
``c_m = b * tau_m + t_{m->c}`` on an event-driven clock
(``repro_torch.core.events``), merging at the cloud on arrival with a
bounded staleness lag.

Stochastic extension (``repro_torch.core.stochastic``): every function
below that takes ``delay_model=``/``model=`` replaces the paper's
constants with per-cycle draws — ``async_completion`` feeds a pre-sampled
``(C, M)`` matrix to the event engine, the ``expected_``/``quantile_``
variants of ``edge_round_time`` summarize the tau_m distribution, and
``makespan_distribution``/``quantile_makespan`` Monte-Carlo the
sync-vs-async makespan comparison.  Under draws the "sync makespan" is
``sum_r max_m c_m^(r)``.  A function that draws takes ``key`` (a
``stochastic.Key`` or an int seed) and ``device=``, used only for an int
seed (``None``: the card).

Fault extension (``repro_torch.core.faults``):
``faulty_async_completion`` runs the event engine over one
``faulty_cycle_stats`` draw with the policy's deadlines, retries, outage
windows and failover, and ``fault_makespan_distribution`` compares
policies over trials under common random numbers.

Copied from the JAX package's ``repro/core/delay.py``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import events
from repro_torch.core.problem import HFLProblem


def local_iterations(theta: float, zeta: float) -> float:
    """eq. (2): a = zeta * ln(1/theta)."""
    return zeta * np.log(1.0 / theta)


def edge_iterations(mu: float, theta: float, gamma: float) -> float:
    """eq. (7): b = gamma * ln(1/mu) / (1 - theta)."""
    return gamma * np.log(1.0 / mu) / (1.0 - theta)


def theta_of_a(a, zeta: float):
    """Invert eq. (2): theta = e^{-a/zeta}."""
    return np.exp(-np.asarray(a, float) / zeta)


def mu_of_b(a, b, zeta: float, gamma: float):
    """Invert eq. (7): mu = e^{-(b/gamma)(1-theta)}."""
    return np.exp(-(np.asarray(b, float) / gamma) * (1.0 - theta_of_a(a, zeta)))


def cloud_rounds(a, b, *, epsilon: float, zeta: float, gamma: float,
                 big_c: float = 1.0):
    """eq. (15): R(a,b,eps) = C ln(1/eps) / (1 - e^{-(b/gamma)(1-e^{-a/zeta})})."""
    a = np.asarray(a, float)
    b = np.asarray(b, float)
    denom = 1.0 - np.exp(-(b / gamma) * (1.0 - np.exp(-a / zeta)))
    return big_c * np.log(1.0 / epsilon) / np.maximum(denom, 1e-300)


def edge_round_time(problem: HFLProblem, assoc: np.ndarray, a) -> np.ndarray:
    """tau_m (eq. 33): per-edge time of one edge round, shape (M,).

    Edges with no associated UEs contribute 0.  Vectorized segment-max:
    one ``np.maximum.at`` scatter over the member edges instead of a
    Python loop over M.
    """
    t_cmp = problem.t_cmp()
    t_com = problem.t_com(assoc)
    per_ue = np.asarray(a, float) * t_cmp + t_com          # (N,)
    tau = np.zeros(problem.num_edges)
    n_idx, m_idx = np.nonzero(assoc)
    np.maximum.at(tau, m_idx, per_ue[n_idx])
    return tau


def cloud_round_time(problem: HFLProblem, assoc: np.ndarray, a, b) -> float:
    """T (eq. 34): max_m { b * tau_m + t_{m->c} } — the max of the
    per-edge cycle times (``edge_cycle_time``), so the synchronous bound
    and the async timeline share one float-identical formula."""
    return float(edge_cycle_time(problem, assoc, a, b).max())


def total_delay(problem: HFLProblem, assoc: np.ndarray, a, b) -> float:
    """Objective of problem (13): R(a,b,eps) * T."""
    r = cloud_rounds(a, b, epsilon=problem.epsilon, zeta=problem.zeta,
                     gamma=problem.gamma, big_c=problem.big_c)
    return float(r) * cloud_round_time(problem, assoc, a, b)


def objective_breakdown(problem: HFLProblem, assoc: np.ndarray, a, b) -> dict:
    """All intermediate quantities, for tests/benchmarks."""
    tau = edge_round_time(problem, assoc, a)
    t_mc = problem.t_edge_cloud()
    T = cloud_round_time(problem, assoc, a, b)
    r = float(cloud_rounds(a, b, epsilon=problem.epsilon, zeta=problem.zeta,
                           gamma=problem.gamma, big_c=problem.big_c))
    return {
        "a": float(a), "b": float(b),
        "tau": tau, "t_edge_cloud": t_mc, "T": T,
        "R": r, "total": r * T,
        "theta": float(theta_of_a(a, problem.zeta)),
        "mu": float(mu_of_b(a, b, problem.zeta, problem.gamma)),
    }


def association_latency(problem: HFLProblem, assoc: np.ndarray, a) -> float:
    """Objective of sub-problem II (eq. 38): max_n { a t_cmp + t_com }."""
    t = np.asarray(a, float) * problem.t_cmp() + problem.t_com(assoc)
    return float(t.max())


# ---------------------------------------------------------------------------
# BEYOND-PAPER: asynchronous completion-time distribution.
# ---------------------------------------------------------------------------


def edge_cycle_time(problem: HFLProblem, assoc: np.ndarray, a, b) -> np.ndarray:
    """Per-edge full cycle ``c_m = b * tau_m + t_{m->c}``, shape (M,).

    This is the per-edge term INSIDE eq. 34's max: one complete pass of b
    edge rounds (eq. 33 each) plus the edge->cloud upload (eq. 8).  The
    synchronous bound is ``T = max_m c_m``; the async timeline lets each
    edge repeat ``c_m`` at its own clock.  Edges with no associated UEs
    contribute 0 (they never participate).
    """
    tau = edge_round_time(problem, assoc, a)
    active = assoc.sum(0) > 0
    return np.asarray(b, float) * tau + np.where(active,
                                                 problem.t_edge_cloud(), 0.0)


def async_completion(problem: HFLProblem, assoc: np.ndarray, a, b, *,
                     rounds: int, max_staleness: int, delay_model=None,
                     key=0, participation=None, device=None) -> dict:
    """Event-driven async completion-time statistics vs. the eq. 34 bound.

    Simulates ``rounds * M_active`` edge->cloud deliveries (the same
    communication work as ``rounds`` synchronous cloud rounds) over the
    per-edge cycle times with SSP staleness gating
    (``repro_torch.core.events``).

    With ``delay_model=`` (a ``repro_torch.core.stochastic.DelayModel``),
    one ``cycle_times`` call pre-samples the whole
    ``(rounds + max_staleness, M)`` matrix under ``key`` and every edge
    cycle consumes a fresh row.  The sync reference then becomes
    ``sum_r max_m c_m^(r)`` over the SAME draws (common random numbers).
    ``delay_model=DeterministicDelays()`` reproduces the constant-delay
    trace event-for-event.

    Returns a dict with the timeline and the headline quantities:

    * ``makespan``        — async wall clock for the delivery quota;
    * ``sync_makespan``   — the synchronous bound: ``rounds * T`` (eq. 34),
      or the per-round-max sum under draws;
    * ``speedup``         — sync_makespan / makespan (1.0 at max_staleness=0);
    * ``cloud_idle_frac`` — longest no-arrival window / makespan;
    * ``edge_busy_frac``  — (M,) per-edge compute fraction (0 for inactive);
    * ``arrivals``        — (t, edge, cycle, staleness) per delivery, in
      global edge indices.

    ``participation``: optional bool ``(rounds + max_staleness, N)`` (or
    ``(N,)``) cohort masks — each cycle's tau is the member max over that
    cycle's participants only; without a ``delay_model`` the paper's
    constants are used (``DeterministicDelays``).
    """
    active = np.flatnonzero(np.asarray(assoc).sum(0) > 0)
    if delay_model is None and participation is not None:
        from repro_torch.core import stochastic
        delay_model = stochastic.DeterministicDelays()
    if delay_model is None:
        cycles = edge_cycle_time(problem, assoc, a, b)[active]
        sync = float(rounds) * cloud_round_time(problem, assoc, a, b)
    else:
        kw = {} if participation is None else {"participation": participation}
        draws = delay_model.cycle_times(key, problem, assoc, a, b,
                                        int(rounds) + int(max_staleness),
                                        device=device, **kw)
        cycles = np.asarray(draws)[:, active]
        sync = float(cycles[:int(rounds)].max(axis=1).sum())
    tl = events.simulate_async(cycles, rounds=int(rounds),
                               max_staleness=int(max_staleness))
    busy = np.zeros(problem.num_edges)
    busy[active] = tl.edge_busy_frac()
    arrivals = [(u.t, int(active[e]), int(c), int(s))
                for u in tl.updates for e, c, s in u.merges]
    return {
        "timeline": tl,
        "active_edges": active,
        "makespan": tl.makespan,
        "sync_makespan": sync,
        "speedup": sync / tl.makespan if tl.makespan > 0 else 1.0,
        "cloud_idle_frac": tl.cloud_idle_frac(),
        "edge_busy_frac": busy,
        "arrivals": arrivals,
    }


# ---------------------------------------------------------------------------
# BEYOND-PAPER: stochastic-delay summaries (repro_torch.core.stochastic).
# ---------------------------------------------------------------------------


def edge_round_time_stats(problem: HFLProblem, assoc: np.ndarray, a, *,
                          model, key=0, num_samples: int = 256,
                          qs=(0.5, 0.95), device=None) -> dict:
    """Monte-Carlo summary of tau_m (eq. 33) under a stochastic model.

    One vectorized draw of ``num_samples`` edge rounds; returns
    ``{"draws": (S, M), "mean": (M,), "quantiles": {q: (M,)}}``.  With
    ``DeterministicDelays`` every row (and every quantile) equals
    ``edge_round_time`` exactly; the mean only up to float summation.
    """
    draws = np.asarray(model.edge_round_times(key, problem, assoc, a,
                                              int(num_samples),
                                              device=device))
    return {
        "draws": draws,
        "mean": draws.mean(axis=0),
        "quantiles": {float(q): np.quantile(draws, q, axis=0) for q in qs},
    }


def expected_edge_round_time(problem: HFLProblem, assoc: np.ndarray, a, *,
                             model, key=0, num_samples: int = 256,
                             device=None) -> np.ndarray:
    """E[tau_m] under ``model`` — the stochastic analogue of
    ``edge_round_time`` (exactly it, for ``DeterministicDelays``)."""
    return edge_round_time_stats(problem, assoc, a, model=model, key=key,
                                 num_samples=num_samples,
                                 device=device)["mean"]


def quantile_edge_round_time(problem: HFLProblem, assoc: np.ndarray, a,
                             q: float = 0.95, *, model, key=0,
                             num_samples: int = 256,
                             device=None) -> np.ndarray:
    """Per-edge tau_m q-quantile — the straggler-aware round time the
    deterministic eq. 33 understates."""
    return edge_round_time_stats(problem, assoc, a, model=model, key=key,
                                 num_samples=num_samples, qs=(q,),
                                 device=device)["quantiles"][float(q)]


def makespan_distribution(problem: HFLProblem, assoc: np.ndarray, a, b, *,
                          rounds: int, max_staleness: int, model, key=0,
                          num_trials: int = 64, device=None) -> dict:
    """Monte-Carlo sync-vs-async makespan distributions under ``model``.

    ONE vectorized draw covers all ``num_trials`` independent timelines
    (``num_trials * (rounds + max_staleness)`` cycle rows, reshaped per
    trial); each trial replays the event engine on its slice and scores
    the synchronous barrier ``sum_r max_m c_m^(r)`` on the same rows.
    Returns per-trial makespans plus p50/p95 summaries.
    """
    rounds, max_staleness = int(rounds), int(max_staleness)
    n_cycles = rounds + max_staleness
    active = np.flatnonzero(np.asarray(assoc).sum(0) > 0)
    draws = np.asarray(model.cycle_times(key, problem, assoc, a, b,
                                         int(num_trials) * n_cycles,
                                         device=device))
    draws = draws.reshape(int(num_trials), n_cycles, -1)[:, :, active]
    async_ms = crn_async_makespans(draws, rounds=rounds,
                                   max_staleness=max_staleness)
    sync_ms = np.array([float(d[:rounds].max(axis=1).sum()) for d in draws])
    return {
        "async_makespans": async_ms,
        "sync_makespans": sync_ms,
        "async_p50": float(np.quantile(async_ms, 0.5)),
        "async_p95": float(np.quantile(async_ms, 0.95)),
        "sync_p50": float(np.quantile(sync_ms, 0.5)),
        "sync_p95": float(np.quantile(sync_ms, 0.95)),
        "speedup_p50": float(np.quantile(sync_ms, 0.5) /
                             np.quantile(async_ms, 0.5)),
        "speedup_p95": float(np.quantile(sync_ms, 0.95) /
                             np.quantile(async_ms, 0.95)),
    }


def crn_async_makespans(cycles: np.ndarray, *, rounds: int,
                        max_staleness: int) -> np.ndarray:
    """Async makespans over PRE-SAMPLED per-trial cycle matrices
    ``(num_trials, C, M_active)``: callers that score many candidates
    against ONE keyed draw replay the event engine here, so per-trial
    makespan gaps isolate the candidate, not the noise.  Returns the
    (num_trials,) makespans."""
    cycles = np.asarray(cycles, float)
    rounds, max_staleness = int(rounds), int(max_staleness)
    out = np.empty(cycles.shape[0])
    for i in range(cycles.shape[0]):
        tl = events.simulate_async(cycles[i, :rounds + max_staleness],
                                   rounds=rounds,
                                   max_staleness=max_staleness)
        out[i] = tl.makespan
    return out


def quantile_makespan(problem: HFLProblem, assoc: np.ndarray, a, b, *,
                      rounds: int, max_staleness: int, model, key=0,
                      num_trials: int = 32, q: float = 0.95,
                      device=None) -> float:
    """q-quantile of the async makespan under ``model`` — the robust
    objective ``assoc.refined(objective="quantile_makespan")`` descends.
    Keyed sampling makes repeated calls comparable (common random
    numbers across candidate associations)."""
    d = makespan_distribution(problem, assoc, a, b, rounds=rounds,
                              max_staleness=max_staleness, model=model,
                              key=key, num_trials=num_trials, device=device)
    return float(np.quantile(d["async_makespans"], q))


# ---------------------------------------------------------------------------
# BEYOND-PAPER: fault-injected completion times (repro_torch.core.faults).
# ---------------------------------------------------------------------------


def faulty_async_completion(problem: HFLProblem, assoc: np.ndarray, a, b, *,
                            rounds: int, max_staleness: int, fault_model,
                            policy=None, delay_model=None, key=0,
                            device=None) -> dict:
    """Deadline/retry/failover-aware makespan under injected faults.

    Samples one ``faults.faulty_cycle_stats`` batch under ``key`` and runs
    the event engine over the policy-adjusted cycle times with the outage
    windows threaded through (in-flight cycles voided, repairs emitted as
    trace events).  Under the deadline+failover policy, down edges are
    excluded from the staleness floor and their orphans re-associated by
    ``assoc.failover``: the cycle rows an outage spans are re-scored under
    the failover association with the SAME key object, so the underlying
    draws are common and only the uplink targets change.

    Returns the ``async_completion`` dict plus fault accounting:
    ``cycle_stats``, ``delivered_frac`` (mean delivered weight fraction per
    edge over the consumed cycles), ``survivor_frac``, ``num_failures`` /
    ``num_repairs`` and the ``windows``.
    """
    from repro_torch.core import assoc as assoc_lib
    from repro_torch.core import faults as faults_lib
    from repro_torch.core import stochastic
    if policy is None:
        policy = faults_lib.FaultPolicy()
    key = stochastic.ensure_key(key, device)
    A = np.asarray(assoc)
    active = np.flatnonzero(A.sum(0) > 0)
    m_act = len(active)
    rounds, max_staleness = int(rounds), int(max_staleness)
    # Failover lets survivors run extra cycles to fill the quota while an
    # edge is down, so pre-sample generously beyond rounds+max_staleness.
    n_cycles = (int(np.ceil(rounds * m_act / max(m_act - 1, 1))) +
                max_staleness + 4)
    fc = faults_lib.faulty_cycle_stats(fault_model, policy, key, problem,
                                       A, a, b, n_cycles,
                                       delay_model=delay_model)
    cycle_times = fc.cycle_times.copy()
    windows = fc.windows
    if policy.failover and windows:
        det_cycle = edge_cycle_time(problem, A, a, b)
        for m in sorted({w[0] for w in windows}):
            A_m = assoc_lib.failover(problem, A, [m], a=a)
            fc_m = faults_lib.faulty_cycle_stats(
                fault_model, policy, key, problem, A_m, a, b, n_cycles,
                delay_model=delay_model)
            step = max(float(det_cycle[m]), 1e-12)
            for mm, f, r in windows:
                if mm != m:
                    continue
                c0 = min(int(f // step), n_cycles - 1)
                c1 = min(int(np.ceil(r / step)) + 1, n_cycles)
                others = [k for k in range(problem.num_edges) if k != m]
                cycle_times[c0:c1, others] = fc_m.cycle_times[c0:c1, others]
    if policy.name == faults_lib.WAIT_FOR_ALL:
        # The naive baseline IS the synchronous barrier: the engine runs at
        # max_staleness=0 whatever the caller's bound, the repair time
        # (plus the voided in-flight work) is charged to the stalled cycle
        # and the engine sees no windows (it would void and re-run, i.e.
        # fail over by accident).
        cycle_times = cycle_times + fc.stall
        eng_windows, eng_failover, eng_staleness = [], False, 0
    else:
        eng_windows = [(int(np.searchsorted(active, m)), f, r)
                       for m, f, r in windows if m in active]
        eng_staleness = max_staleness
        eng_failover = policy.failover and max_staleness >= 1
    tl = events.simulate_async(cycle_times[:, active], rounds=rounds,
                               max_staleness=eng_staleness,
                               outages=eng_windows, failover=eng_failover)
    sync = float(cycle_times[:rounds, active].max(axis=1).sum())
    busy = np.zeros(problem.num_edges)
    busy[active] = tl.edge_busy_frac()
    arrivals = [(u.t, int(active[e]), int(c), int(s))
                for u in tl.updates for e, c, s in u.merges]
    consumed = max(c for _, _, c, _ in arrivals) if arrivals else rounds
    return {
        "timeline": tl,
        "active_edges": active,
        "makespan": tl.makespan,
        "sync_makespan": sync,
        "speedup": sync / tl.makespan if tl.makespan > 0 else 1.0,
        "cloud_idle_frac": tl.cloud_idle_frac(),
        "edge_busy_frac": busy,
        "arrivals": arrivals,
        "cycle_stats": fc,
        "delivered_frac": fc.delivered_frac[:consumed].mean(axis=0),
        "survivor_frac": float(fc.survivors[:consumed].mean()),
        "num_failures": len(tl.failures),
        "num_repairs": len(tl.repairs),
        "windows": windows,
    }


def fault_makespan_distribution(problem: HFLProblem, assoc: np.ndarray, a,
                                b, *, rounds: int, max_staleness: int,
                                fault_model, policies, delay_model=None,
                                key=0, num_trials: int = 32,
                                device=None) -> dict:
    """Monte-Carlo makespan/delivery comparison across fault POLICIES.

    Trial ``i`` runs every policy on ``key.fold_in(i)`` (common random
    numbers, so per-trial gaps isolate the handling policy).  ``policies``
    is a ``{name: FaultPolicy}`` mapping; returns per-policy makespan
    arrays, p50/p95 and mean delivered fractions.
    """
    from repro_torch.core import stochastic
    base = stochastic.ensure_key(key, device)
    names = list(policies)
    ms = {n: np.empty(int(num_trials)) for n in names}
    df = {n: np.empty(int(num_trials)) for n in names}
    for i in range(int(num_trials)):
        k = base.fold_in(i)
        for n in names:
            r = faulty_async_completion(
                problem, assoc, a, b, rounds=rounds,
                max_staleness=max_staleness, fault_model=fault_model,
                policy=policies[n], delay_model=delay_model, key=k)
            ms[n][i] = r["makespan"]
            df[n][i] = float(np.mean(r["delivered_frac"]))
    out: dict = {"makespans": ms}
    for n in names:
        out[f"{n}_p50"] = float(np.quantile(ms[n], 0.5))
        out[f"{n}_p95"] = float(np.quantile(ms[n], 0.95))
        out[f"{n}_delivered_frac"] = float(df[n].mean())
    return out
