"""Delay model — eqs. (1)–(8), the objective of problem (13), and the
BEYOND-PAPER asynchronous completion time under constant delays.

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

Copied from the JAX package's ``repro/core/delay.py``: the deterministic
part only.  Its per-cycle draws (``delay_model=``), the stochastic
summaries and the fault-injected makespans wait for the port of the
stochastic and fault models (ROADMAP Queue 1 items 8-9).
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
                     rounds: int, max_staleness: int) -> dict:
    """Event-driven async completion-time statistics vs. the eq. 34 bound.

    Simulates ``rounds * M_active`` edge->cloud deliveries (the same
    communication work as ``rounds`` synchronous cloud rounds) over the
    constant per-edge cycle times with SSP staleness gating
    (``repro_torch.core.events``).

    Returns a dict with the timeline and the headline quantities:

    * ``makespan``        — async wall clock for the delivery quota;
    * ``sync_makespan``   — the synchronous bound ``rounds * T`` (eq. 34);
    * ``speedup``         — sync_makespan / makespan (1.0 at max_staleness=0);
    * ``cloud_idle_frac`` — longest no-arrival window / makespan;
    * ``edge_busy_frac``  — (M,) per-edge compute fraction (0 for inactive);
    * ``arrivals``        — (t, edge, cycle, staleness) per delivery, in
      global edge indices.
    """
    active = np.flatnonzero(np.asarray(assoc).sum(0) > 0)
    cycles = edge_cycle_time(problem, assoc, a, b)[active]
    sync = float(rounds) * cloud_round_time(problem, assoc, a, b)
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
