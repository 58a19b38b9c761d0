"""Stochastic joint optimizer — (a, b, max_staleness, bandwidth), BEYOND-PAPER.

Sub-problem I (``core.iteropt``) picks the iteration counts (a, b)
against the paper's DETERMINISTIC eqs. 33/34, but under a stochastic
``Scenario`` the q-quantile async makespan is the objective that actually
matters.  This module closes that gap:

* ``solve_joint`` searches candidate (a, b, max_staleness) tuples
  against the quantile time-to-target under any registered scenario
  model, scoring EVERY tuple on one keyed batched ingredient draw
  (``IngredientDraws`` — common random numbers), so the search surface
  is low-variance and repeated calls are comparable.  With
  ``DeterministicDelays`` the draw has zero variance, every quantile
  collapses to the deterministic value and the (a, b) surface IS the
  eq. 13 objective R*T — so the solver provably reduces to (and
  delegates to) ``iteropt.solve_direct``'s answer.
* ``optimize_bandwidth`` goes beyond the paper's equal eq. 4 split
  B/|N_m|: each cell's bandwidth is divided across its member UEs by
  bisection on the convex per-edge bottleneck (the resource-allocation
  move of "Delay Minimization for Federated Learning over Wireless
  Communication Networks", arXiv 2007.03462), vectorized over edges.
  The split equalizes member finish times where possible and recovers
  the equal split exactly when a cell's UEs are symmetric.
* ``assoc.refined(objective="joint")`` scores association moves with the
  bandwidth split re-optimized per candidate, so chi, (a, b), staleness
  and bandwidth co-optimize.

Ported from the JAX package's ``repro/core/jointopt.py``.  The search is
numpy; only ``sample_ingredients`` draws, through the port's
``stochastic.Key`` (split where the reference splits) on the key's device,
and brings the draws back to the host as float64.  ``device=`` places an
int key's draws (``None``: the card, raising without one);
``DeterministicDelays`` never resolves a device.

Objective.  The paper's eq. 13 minimizes R(a,b,eps) * T(a,b,chi).  The
stochastic generalization scored here is the q-quantile of the ASYNC
time to finish R_c = ceil(R(a,b,eps)) cloud rounds of communication
work under per-cycle draws.  Large-R candidates are simulated for at
most ``rounds_cap`` rounds and extrapolated linearly (the async
timeline is steady-state cyclic, so makespan is ~linear in the round
quota); at ``max_staleness=0`` and zero variance the score is exactly
``ceil(R) * T`` — eq. 13 up to integer rounding.

Draw reuse.  One cycle of candidate (a, b) costs
``sum_{j<b} tau^(j) + t_mc`` over b edge-round draws.  The batched draw
is laid out ``(num_trials, cycles, b_max, N)``: round j of cycle c of
trial t reuses ingredient row (t, c, j) for EVERY candidate, so two
candidates that share a round index see the SAME compute/fade draws.
Compute draws are a-independent and upload draws bandwidth-scale
EXACTLY (every registered model's upload time is inversely proportional
to the allocated bandwidth — fades multiply the SNR, not B), so one
draw serves all (a, b, s, bandwidth) tuples.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import delay, iteropt
from repro_torch.core.problem import HFLProblem

#: Most cloud rounds simulated per candidate evaluation; larger R(a,b)
#: is extrapolated linearly from this many rounds.
DEFAULT_ROUNDS_CAP = 48

#: Default max_staleness candidates (0 = the paper's sync barrier).
DEFAULT_STALENESS_GRID = (0, 1, 2, 4)

#: Candidate (a, b) grids scale the deterministic optimum by these.
DEFAULT_SCALE_FACTORS = (0.5, 0.75, 1.0, 1.5, 2.0)

#: Candidates whose ceil(R(a,b,eps)) exceeds this are hopeless; scored inf.
_R_CAP = 1e5


# ---------------------------------------------------------------------------
# Per-cell bandwidth allocation (arXiv 2007.03462) — vectorized bisection.
# ---------------------------------------------------------------------------


def optimize_bandwidth(problem: HFLProblem, assoc: np.ndarray, a, *,
                       iters: int = 64) -> np.ndarray:
    """Optimal per-UE share of each cell's uplink bandwidth, shape (N,).

    Solves, independently per edge m (vectorized — one bisection loop
    advances every edge at once), the convex bottleneck problem

        min_{p}  max_{n in N_m}  a*t_cmp_n + d_n / (p_n * B * log2(1+snr_n))
        s.t.     sum_{n in N_m} p_n = 1,   p_n > 0

    — the per-cell resource allocation of arXiv 2007.03462 dropped into
    the eq. 4 Shannon rate.  For a candidate bottleneck time T the
    minimal feasible share is ``p_n(T) = u_n / (T - a*t_cmp_n)`` with
    ``u_n = d_n / (B log2(1+snr_n))`` the full-band upload time; the
    member sum is strictly decreasing in T, so bisection on
    ``sum p_n(T) = 1`` finds the optimum (all members finish together —
    waterfilling).  When a cell's members are symmetric (same t_cmp and
    SNR) the solution is exactly the paper's equal split 1/|N_m|.

    Returns fractions summing to 1 within every non-empty cell;
    unassociated UEs get 0.  Apply via ``problem.bandwidth_frac = frac``.
    """
    A = np.asarray(assoc)
    N, M = A.shape
    assigned = A.sum(1) > 0
    gid = np.where(assigned, A.argmax(1), M)          # overflow segment M
    snr = problem.snr()[np.arange(N), np.minimum(gid, M - 1)]
    u = problem.model_bits / (problem.bandwidth_total *
                              np.log2(1.0 + snr))     # full-band upload (N,)
    t0 = float(a) * problem.t_cmp()                   # compute offset (N,)

    def seg_sum(x):
        out = np.zeros(M + 1)
        np.add.at(out, gid, np.where(assigned, x, 0.0))
        return out[:M]

    t0_max = np.full(M + 1, -np.inf)
    np.maximum.at(t0_max, gid, np.where(assigned, t0, -np.inf))
    t0_max = t0_max[:M]
    occupied = seg_sum(np.ones(N)) > 0
    t0_max = np.where(occupied, t0_max, 0.0)
    u_sum = seg_sum(u)
    lo = t0_max
    hi = t0_max + np.where(occupied, u_sum, 1.0)      # sum p(hi) <= 1
    for _ in range(int(iters)):
        mid = 0.5 * (lo + hi)
        gap = np.maximum(mid[np.minimum(gid, M - 1)] - t0, 1e-300)
        s = seg_sum(u / gap)
        feasible = s <= 1.0
        hi = np.where(feasible, mid, hi)
        lo = np.where(feasible, lo, mid)
    gap = np.maximum(hi[np.minimum(gid, M - 1)] - t0, 1e-300)
    p = np.where(assigned, u / gap, 0.0)
    cell = seg_sum(p)
    norm = np.where(cell > 0, cell, 1.0)[np.minimum(gid, M - 1)]
    return np.where(assigned, p / norm, 0.0)


def uplink_rescale(problem: HFLProblem, assoc: np.ndarray,
                   frac: np.ndarray) -> np.ndarray:
    """Per-UE factor turning uplink draws sampled under the problem's
    CURRENT split into draws under ``frac``, shape (N,).

    Exact for every registered model: upload time is ``d / (B_n *
    log2(1+snr*fade))``, so changing only the allocation multiplies each
    draw by ``B_n_old / B_n_new`` — fades untouched.  This is what lets
    one ``IngredientDraws`` batch serve every bandwidth candidate.
    """
    bn_old = problem.ue_bandwidth_alloc(assoc)
    bn_new = problem.bandwidth_total * np.asarray(frac, float)
    ok = (bn_old > 0) & (bn_new > 0)
    return np.where(ok, bn_old / np.where(ok, bn_new, 1.0), 1.0)


# ---------------------------------------------------------------------------
# Common-random-numbers ingredient draws.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class IngredientDraws:
    """One keyed batched draw of every delay ingredient — the CRN surface
    all candidate (a, b, max_staleness, bandwidth) tuples are scored on.

    ``compute``/``uplink`` are ``(num_trials, cycles, b_max, N)`` per-
    edge-round draws, ``backhaul`` is ``(num_trials, cycles, M)`` — round
    j of cycle c of trial t reuses row (t, c, j) for every candidate.
    Build via ``sample_ingredients``.
    """
    problem: HFLProblem
    assoc: np.ndarray
    compute: np.ndarray
    uplink: np.ndarray
    backhaul: np.ndarray
    members: List[np.ndarray]
    active: np.ndarray          # (M,) bool
    active_idx: np.ndarray      # indices of active edges

    @property
    def num_trials(self) -> int:
        return self.compute.shape[0]

    @property
    def cycles(self) -> int:
        return self.compute.shape[1]

    @property
    def b_max(self) -> int:
        return self.compute.shape[2]

    def cycle_times(self, a, b, uplink_scale=None) -> np.ndarray:
        """(num_trials, cycles, M) per-cycle times at candidate (a, b).

        eq. 33 member max per round draw, summed over the candidate's b
        rounds, plus the backhaul draw (inactive edges 0) — the same
        semantics as ``DelayModel.cycle_times`` on shared rows.
        ``uplink_scale`` (N,) re-prices the upload draws for a bandwidth
        candidate (``uplink_rescale``).
        """
        b = int(b)
        if not 1 <= b <= self.b_max:
            raise ValueError(f"b={b} outside the drawn range "
                             f"[1, {self.b_max}]")
        up = self.uplink[:, :, :b, :]
        if uplink_scale is not None:
            up = up * np.asarray(uplink_scale, float)[None, None, None, :]
        per_ue = float(a) * self.compute[:, :, :b, :] + up
        T, C = per_ue.shape[:2]
        M = self.assoc.shape[1]
        tau = np.zeros((T, C, b, M))
        for m, mem in enumerate(self.members):
            if mem.size:
                tau[..., m] = per_ue[..., mem].max(axis=-1)
        return tau.sum(axis=2) + self.backhaul * self.active[None, None, :]


def sample_ingredients(model, key, problem: HFLProblem, assoc, *,
                       num_trials: int, cycles: int, b_max: int,
                       device=None) -> IngredientDraws:
    """ONE keyed batched draw of all ingredients for a joint search.

    Mirrors ``DelayModel.cycle_times``'s key split (so at ``b == b_max``
    the flat draw order matches ``model.cycle_times(key, ...)`` row for
    row), but at the (trials, cycles, b_max) grid every candidate tuple
    shares.  ``DeterministicDelays`` short-circuits to the float64
    constants (zero variance — the reduction path) and never resolves a
    device; otherwise an int ``key`` draws on ``device`` (``None``: the
    card).
    """
    from repro_torch.core import stochastic

    A = np.asarray(assoc)
    N, M = A.shape
    T, C, B = int(num_trials), int(cycles), int(b_max)
    if min(T, C, B) < 1:
        raise ValueError(f"num_trials/cycles/b_max must be >= 1, got "
                         f"({T}, {C}, {B})")
    members = [np.flatnonzero(A[:, m] > 0) for m in range(M)]
    active = A.sum(0) > 0
    if isinstance(model, stochastic.DeterministicDelays):
        comp = np.broadcast_to(problem.t_cmp(), (T, C, B, N))
        up = np.broadcast_to(problem.t_com(A), (T, C, B, N))
        bh = np.broadcast_to(problem.t_edge_cloud(), (T, C, M))
    else:
        kr, kb = stochastic.ensure_key(key, device).split()
        kc, ku = kr.split()

        def host(t, shape):
            return t.cpu().numpy().astype(np.float64).reshape(shape)

        comp = host(model.sample_compute(kc, problem, T * C * B),
                    (T, C, B, N))
        up = host(model.sample_uplink(ku, problem, A, T * C * B),
                  (T, C, B, N))
        bh = host(model.sample_backhaul(kb, problem, T * C), (T, C, M))
    return IngredientDraws(problem=problem, assoc=A, compute=comp, uplink=up,
                           backhaul=bh, members=members, active=active,
                           active_idx=np.flatnonzero(active))


# ---------------------------------------------------------------------------
# Candidate evaluation and the joint search.
# ---------------------------------------------------------------------------


def candidate_rounds(problem: HFLProblem, a, b) -> float:
    """ceil(R(a, b, eps)) — the eq. 15 work quota of a candidate (inf if
    the denominator underflows or R exceeds the hopeless cap)."""
    r = float(delay.cloud_rounds(a, b, epsilon=problem.epsilon,
                                 zeta=problem.zeta, gamma=problem.gamma,
                                 big_c=problem.big_c))
    if not np.isfinite(r) or r > _R_CAP:
        return math.inf
    return max(math.ceil(r), 1)


def evaluate_tuple(problem: HFLProblem, assoc: np.ndarray, a, b,
                   max_staleness, *, draws: IngredientDraws, q: float = 0.95,
                   rounds_cap: int = DEFAULT_ROUNDS_CAP, uplink_scale=None,
                   return_makespans: bool = False):
    """q-quantile stochastic time-to-target of one (a, b, s) tuple.

    ``ceil(R(a,b,eps))`` rounds of async work on ``draws``' shared rows,
    simulated up to ``rounds_cap`` rounds and extrapolated linearly.
    Same draws + same tuple => bit-identical score (the brute-force
    cross-check and CRN-dominance properties in
    the JAX package's property tests rely on this).
    """
    r_c = candidate_rounds(problem, a, b)
    if not np.isfinite(r_c):
        return (math.inf, None) if return_makespans else math.inf
    sim = min(int(r_c), int(rounds_cap))
    s = int(max_staleness)
    if sim + s > draws.cycles:
        raise ValueError(f"draws hold {draws.cycles} cycles; candidate needs "
                         f"{sim + s} (rounds_cap + max_staleness)")
    cyc = draws.cycle_times(a, b, uplink_scale)[:, :sim + s, :]
    cyc = cyc[:, :, draws.active_idx]
    ms = delay.crn_async_makespans(cyc, rounds=sim, max_staleness=s)
    ms = ms * (float(r_c) / sim)
    obj = float(np.quantile(ms, q))
    return (obj, ms) if return_makespans else obj


@dataclasses.dataclass
class JointSolution:
    """Result of ``solve_joint`` — the stochastic-optimal joint tuple."""
    a: int
    b: int
    max_staleness: int
    objective: float                       # q-quantile time-to-target
    rounds: int                            # ceil(R(a, b, eps))
    q: float
    bandwidth: str                         # "equal" | "optimized"
    bandwidth_frac: Optional[np.ndarray]   # (N,) split; None if equal won
    deterministic_anchor: iteropt.IterSolution
    history: List[Tuple[int, int, int, str, float]]  # (a, b, s, bw, obj)


def _scaled_grid(v: int,
                 factors: Sequence[float] = DEFAULT_SCALE_FACTORS) -> list:
    return sorted({max(1, int(round(v * f))) for f in factors})


def solve_joint(problem: HFLProblem, assoc: np.ndarray, *, model=None,
                q: float = 0.95, num_trials: int = 16, key=0,
                staleness_grid: Sequence[int] = DEFAULT_STALENESS_GRID,
                a_candidates: Optional[Sequence[int]] = None,
                b_candidates: Optional[Sequence[int]] = None,
                constrain_mu: bool = True, optimize_bw: bool = True,
                rounds_cap: int = DEFAULT_ROUNDS_CAP, b_cap: int = 64,
                draws: Optional[IngredientDraws] = None,
                device=None) -> JointSolution:
    """Joint (a, b, max_staleness, bandwidth) search under a scenario.

    ``model`` is a ``stochastic.DelayModel``, a registered scenario name,
    or None (``urban_stragglers``).  Candidate (a, b) grids default to
    integer scalings of ``iteropt.solve_direct``'s deterministic optimum
    (the anchor), b clamped up to the mu-feasibility floor when
    ``constrain_mu`` and capped at ``b_cap``; every tuple is scored by
    ``evaluate_tuple`` on ONE shared ``IngredientDraws`` batch (pass
    ``draws=`` to reuse/cross-check it).  Ties break toward smaller
    (staleness, b, a) deterministically.

    ``optimize_bw`` makes the bandwidth allocation a SEARCH DIMENSION:
    every (a, b, s) is scored under both the paper's equal split and the
    per-cell waterfilling split for that ``a`` (``optimize_bandwidth``,
    by exact rescaling of the shared upload draws).  The waterfilling
    split minimizes the DETERMINISTIC bottleneck, but under heavy fades
    it can lose — equalized finish times make every member near-critical,
    inflating the per-round E[max] — so neither allocation is assumed;
    the winner's split is returned as ``bandwidth_frac`` (None when the
    equal split won; else apply with ``problem.bandwidth_frac = ...``).

    Deterministic reduction: with ``DeterministicDelays`` every draw is
    the eq. 33/34 constant, the quantile objective collapses to
    ``ceil(R) * T`` — monotone in the same surface ``solve_direct``
    already minimizes — so the solver returns EXACTLY ``solve_direct``'s
    (a_int, b_int) and only staleness/bandwidth are searched on top.

    ``device`` places an int ``key``'s draws (``None``: the card).
    """
    from repro_torch.core import stochastic

    if isinstance(model, str):
        model = stochastic.scenario(model).model
    if model is None:
        model = stochastic.scenario("urban_stragglers").model
    A = np.asarray(assoc)
    det = iteropt.solve_direct(problem, A, constrain_mu=constrain_mu)
    deterministic = isinstance(model, stochastic.DeterministicDelays)

    staleness_grid = sorted({int(s) for s in staleness_grid})
    if not staleness_grid or staleness_grid[0] < 0:
        raise ValueError(f"staleness_grid must be non-negative ints, got "
                         f"{staleness_grid}")
    if deterministic:
        b_for: Dict[int, list] = {det.a_int: [det.b_int]}
    else:
        a_list = (_scaled_grid(det.a_int) if a_candidates is None
                  else sorted({int(x) for x in a_candidates if int(x) >= 1}))
        base_b = (_scaled_grid(det.b_int) if b_candidates is None
                  else sorted({int(x) for x in b_candidates if int(x) >= 1}))
        if not a_list or not base_b:
            raise ValueError("empty candidate grid")
        b_for = {}
        for a in a_list:
            floor = (int(np.ceil(iteropt.b_min_for_mu(problem, a) - 1e-9))
                     if constrain_mu else 1)
            if floor > int(b_cap):
                continue                   # mu-infeasible within the cap
            b_for[a] = sorted({min(max(bv, floor), int(b_cap))
                               for bv in base_b})
        if not b_for:
            raise ValueError(f"no mu-feasible (a, b) candidates under "
                             f"b_cap={b_cap}")
    b_max = max(max(bs) for bs in b_for.values())
    s_max = staleness_grid[-1]
    if draws is None:
        draws = sample_ingredients(model, key, problem, A,
                                   num_trials=num_trials,
                                   cycles=int(rounds_cap) + s_max,
                                   b_max=b_max, device=device)
    elif draws.b_max < b_max or draws.cycles < int(rounds_cap) + s_max:
        raise ValueError(f"supplied draws ({draws.b_max} rounds x "
                         f"{draws.cycles} cycles) too small for the grid "
                         f"(needs {b_max} x {int(rounds_cap) + s_max})")

    history: List[Tuple[int, int, int, str, float]] = []
    best = None
    for a in sorted(b_for):
        bw_options = [("equal", None, None)]
        if optimize_bw:
            frac = optimize_bandwidth(problem, A, a)
            bw_options.append(("optimized", frac,
                               uplink_rescale(problem, A, frac)))
        for b in b_for[a]:
            for s in staleness_grid:
                for bw_i, (bw, frac, scale) in enumerate(bw_options):
                    obj = evaluate_tuple(problem, A, a, b, s, draws=draws,
                                         q=q, rounds_cap=rounds_cap,
                                         uplink_scale=scale)
                    history.append((a, b, s, bw, obj))
                    rank = (obj, s, b, a, bw_i)   # deterministic tie-break
                    if best is None or rank < best[0]:
                        best = (rank, a, b, s, bw, frac)
    _, a_star, b_star, s_star, bw_star, frac_star = best
    r_star = candidate_rounds(problem, a_star, b_star)
    return JointSolution(a=a_star, b=b_star, max_staleness=s_star,
                         objective=best[0][0],
                         rounds=int(r_star) if np.isfinite(r_star) else -1,
                         q=float(q), bandwidth=bw_star,
                         bandwidth_frac=frac_star,
                         deterministic_anchor=det, history=history)
