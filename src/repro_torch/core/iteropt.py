"""Sub-problem I solvers — the optimal (a, b) iteration counts (§IV-C).

Two solvers, cross-checked against each other in tests/benchmarks:

* ``solve_direct``  — ground truth: the relaxed problem (16) under a given
  association is a 2-D problem in (a, b); we minimize the TRUE objective
  R(a,b,eps)*T(a,b) (T from eqs. 33/34) by continuous minimization + the
  paper's integer rounding.  The paper proves the relaxation convex
  (Lemmas 1-3), so a local minimum is global.

* ``solve_dual``    — the paper's Algorithm 2: Lagrangian-dual subgradient
  iteration on (lambda, mu) with the KKT stationarity conditions (eq. 30)
  solved for (a, b) each iteration.  The printed closed forms (31)/(32)
  contain algebra slips (see DESIGN.md §6), so stationarity is solved
  numerically.

Copied from the JAX package's ``repro/core/iteropt.py`` (numpy/scipy).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
from scipy import optimize as sopt

from repro_torch.core import delay
from repro_torch.core.problem import HFLProblem


@dataclasses.dataclass
class IterSolution:
    a: float
    b: float
    a_int: int
    b_int: int
    total: float            # objective at (a_int, b_int)
    total_relaxed: float    # objective at continuous (a, b)
    rounds: float           # R(a_int, b_int, eps)
    iters: int = 0          # solver iterations
    history: Optional[list] = None


# ---------------------------------------------------------------------------
# Direct convex reference solver
# ---------------------------------------------------------------------------

def _tau_coeffs(problem: HFLProblem, assoc: np.ndarray):
    """tau_m(a) = a*A_m + B_m per edge (piecewise max folded numerically)."""
    t_cmp = problem.t_cmp()
    t_com = problem.t_com(assoc)
    return t_cmp, t_com


def validate_inputs(problem: HFLProblem, assoc: np.ndarray,
                    a_min: float = 1.0, a_max: float = np.inf,
                    b_min: float = 1.0, b_max: float = np.inf) -> None:
    """Reject infeasible solver inputs with ``ValueError`` (never garbage).

    Checks the search box (finite, positive, ``a_max >= a_min`` /
    ``b_max >= b_min``), the learning constants eq. 15 needs
    (``0 < epsilon < 1``, ``zeta > 0``, ``gamma > 0``, ``big_c > 0``) and
    that the round time T (eq. 34) is positive and finite at the box
    corner — a degenerate association (no active edge) or corrupted
    delay terms would otherwise silently minimize over a flat-zero or
    NaN surface.
    """
    for name, lo, hi in (("a", a_min, a_max), ("b", b_min, b_max)):
        if not (np.isfinite(lo) and lo > 0):
            raise ValueError(f"{name}_min must be finite and > 0, got {lo}")
        if not (hi >= lo):          # also catches NaN
            raise ValueError(f"{name}_max must be >= {name}_min "
                             f"({lo}), got {hi}")
    if not (0.0 < problem.epsilon < 1.0):
        raise ValueError(f"epsilon must be in (0, 1) for eq. 15, got "
                         f"{problem.epsilon}")
    for name in ("zeta", "gamma", "big_c"):
        v = getattr(problem, name)
        if not (np.isfinite(v) and v > 0):
            raise ValueError(f"{name} must be finite and > 0, got {v}")
    A = np.asarray(assoc)
    if A.shape != (problem.num_ues, problem.num_edges):
        raise ValueError(f"assoc shape {A.shape} != "
                         f"({problem.num_ues}, {problem.num_edges})")
    t = delay.cloud_round_time(problem, A, a_min, b_min)
    if not (np.isfinite(t) and t > 0):
        raise ValueError(f"round time T(a={a_min}, b={b_min}) = {t} is not "
                         "a positive finite number (no active edge, or "
                         "degenerate delay terms)")


def b_min_for_mu(problem: HFLProblem, a: float) -> float:
    """Smallest b with edge accuracy mu(a,b) <= eps (the mu-feasibility
    coupling).  Eq. (15) alone makes argmin(a,b) INDEPENDENT of eps
    (ln(1/eps) is a constant factor), contradicting the paper's Fig. 2;
    the convergence theory behind eq. (14) [21] needs the edge sub-problem
    solved at least as accurately as the global target, i.e. mu <= eps,
    which restores the eps-dependence (b rises as eps falls).  DESIGN.md §6.
    """
    y = 1.0 - np.exp(-a / problem.zeta)
    return problem.gamma * np.log(1.0 / problem.epsilon) / max(y, 1e-12)


def objective(problem: HFLProblem, assoc: np.ndarray, a: float, b: float,
              constrain_mu: bool = False) -> float:
    if a <= 0 or b <= 0:
        return np.inf
    if constrain_mu and b < b_min_for_mu(problem, a) - 1e-9:
        return np.inf
    return delay.total_delay(problem, assoc, a, b)


def _round_best(problem, assoc, a, b, constrain_mu=False) -> Tuple[int, int, float]:
    """Paper rounding: relax -> round back.  Check the 4 integer neighbours."""
    best = (1, 1, np.inf)
    for ai in {max(1, int(np.floor(a))), max(1, int(np.ceil(a)))}:
        for bi in {max(1, int(np.floor(b))), max(1, int(np.ceil(b)))}:
            if constrain_mu:
                bi = max(bi, int(np.ceil(b_min_for_mu(problem, ai) - 1e-9)))
            v = objective(problem, assoc, ai, bi, constrain_mu)
            if v < best[2]:
                best = (ai, bi, v)
    return best


def solve_direct(problem: HFLProblem, assoc: np.ndarray,
                 a_max: float = 200.0, b_max: float = 200.0,
                 constrain_mu: bool = True,
                 a_min: float = 1.0, b_min: float = 1.0) -> IterSolution:
    """Minimize R*T over the relaxed (a,b) box; multi-start Nelder-Mead in
    log-space (robust to the max() kinks), then integer rounding.

    ``constrain_mu`` enforces mu(a,b) <= eps by clamping b to b_min(a)
    (see ``b_min_for_mu``); pass False for the raw eq. (13)/(15) problem.
    Infeasible boxes (``a_max < a_min``, non-positive bounds) or
    degenerate problems (non-positive round time T, epsilon outside
    (0,1)) raise ``ValueError`` — see ``validate_inputs``.
    """
    validate_inputs(problem, assoc, a_min, a_max, b_min, b_max)

    def f(x):
        a = np.exp(x[0])
        b = np.exp(x[1])
        if constrain_mu:
            b = max(b, b_min_for_mu(problem, a))
        return objective(problem, assoc, a, b)

    best_x, best_v = None, np.inf
    for a0, b0 in [(2, 2), (10, 5), (40, 10), (5, 40), (80, 80)]:
        res = sopt.minimize(f, np.log([a0, b0]), method="Nelder-Mead",
                            options={"xatol": 1e-6, "fatol": 1e-10,
                                     "maxiter": 2000})
        if res.fun < best_v:
            best_v, best_x = res.fun, res.x
    a, b = np.exp(best_x)
    if constrain_mu:
        b = max(b, b_min_for_mu(problem, a))
    a = min(max(a, a_min), a_max)
    b = min(max(b, b_min), b_max)
    ai, bi, v = _round_best(problem, assoc, a, b, constrain_mu)
    r = float(delay.cloud_rounds(ai, bi, epsilon=problem.epsilon,
                                 zeta=problem.zeta, gamma=problem.gamma,
                                 big_c=problem.big_c))
    return IterSolution(a=a, b=b, a_int=ai, b_int=bi, total=v,
                        total_relaxed=best_v, rounds=r)


# ---------------------------------------------------------------------------
# Algorithm 2: Lagrangian-dual subgradient iteration
# ---------------------------------------------------------------------------

def _r_partials(a, b, *, epsilon, zeta, gamma, big_c):
    """R and its partials dR/da, dR/db at (a,b) (eq. 15)."""
    A = big_c * np.log(1.0 / epsilon)
    y = 1.0 - np.exp(-a / zeta)                     # 1 - theta
    e = np.exp(-(b / gamma) * y)
    denom = 1.0 - e
    R = A / denom
    # d(denom)/da = e * (b/gamma) * (1/zeta) e^{-a/zeta}
    dden_da = e * (b / gamma) * np.exp(-a / zeta) / zeta
    dden_db = e * y / gamma
    dR_da = -A * dden_da / denom**2
    dR_db = -A * dden_db / denom**2
    return R, dR_da, dR_db


def _stationarity_solve(problem, sum_mu_tcmp, sum_lam_tau, T, a0, b0):
    """Solve eq. (30): dR/da * T + sum_n mu_n t_cmp_n = 0 and
    dR/db * T + sum_m lambda_m tau_m = 0 for (a,b) numerically."""
    eps_kw = dict(epsilon=problem.epsilon, zeta=problem.zeta,
                  gamma=problem.gamma, big_c=problem.big_c)

    def eqs(x):
        a, b = np.exp(x)
        _, dRa, dRb = _r_partials(a, b, **eps_kw)
        return [dRa * T + sum_mu_tcmp, dRb * T + sum_lam_tau]

    sol = sopt.root(eqs, np.log([max(a0, 1.0), max(b0, 1.0)]), method="hybr")
    a, b = np.exp(sol.x)
    if not sol.success or not np.isfinite([a, b]).all():
        return a0, b0
    return float(np.clip(a, 1e-2, 1e4)), float(np.clip(b, 1e-2, 1e4))


def paper_closed_form_ab(problem, lam, mu, tau, t_cmp, T):
    """Eqs. (31)/(32) exactly as printed (known algebra slips; NaNs possible)."""
    zeta, gamma = problem.zeta, problem.gamma
    s_lt = float(np.sum(lam * tau))
    s_mt = float(np.sum(mu * t_cmp))
    with np.errstate(all="ignore"):
        a = zeta * np.log(s_lt / (zeta * s_mt) + 1.0)
        A = problem.big_c * T * np.log(1.0 / problem.epsilon)
        Y = 1.0 - np.exp(-a / zeta)
        num = A * Y - np.sqrt(4.0 * A * Y * s_lt + (A * Y) ** 2)
        b = gamma * np.log(num / (2.0 * s_lt) + 1.0) / (-Y)
    return float(a), float(b)


def solve_dual(problem: HFLProblem, assoc: np.ndarray,
               eta: float = 0.5, max_iter: int = 500,
               tol: float = 1e-6, temp: float = 0.05,
               constrain_mu: bool = True,
               record_history: bool = False) -> IterSolution:
    """Algorithm 2, completed with the slack-variable stationarity.

    The paper iterates (eq. 30) stationarity in (a, b) against subgradient
    updates (eqs. 36/37) of (lambda, mu) — but omits the stationarity of
    the SLACK variables it introduced in (16):

        dL/dT    = dR/dT-part:  R(a,b)       = sum_m lambda_m,
        dL/dtau_m:              lambda_m * b = sum_{n in N_m} mu_n.

    Without them the subgradients (36) are <= 0 at every iterate (tau*, T*
    are the maxima by construction) and the multipliers collapse to the
    floor.  We therefore update (lambda, mu) toward the KKT-consistent
    values implied by complementary slackness — multipliers concentrate on
    the bottleneck edge/UE (softmax with temperature ``temp`` for
    stability) with totals fixed by the conditions above — with relaxation
    factor ``eta``.  DESIGN.md §6 records this as a deviation: the printed
    algorithm is under-determined, this is its KKT-faithful completion.
    Like ``solve_direct``, degenerate inputs raise ``ValueError``
    (``validate_inputs``) instead of iterating on garbage.
    """
    validate_inputs(problem, assoc)
    N, M = problem.num_ues, problem.num_edges
    t_cmp = problem.t_cmp()
    t_com = problem.t_com(assoc)
    t_mc = problem.t_edge_cloud()
    edge_of = assoc.argmax(1)                      # (N,)
    active = assoc.sum(0) > 0
    eps_kw = dict(epsilon=problem.epsilon, zeta=problem.zeta,
                  gamma=problem.gamma, big_c=problem.big_c)

    def softmax(x, t):
        z = (x - x.max()) / max(t, 1e-9)
        e = np.exp(z)
        return e / e.sum()

    a, b = 5.0, 5.0
    tau = delay.edge_round_time(problem, assoc, a)
    T = delay.cloud_round_time(problem, assoc, a, b)
    R = float(delay.cloud_rounds(a, b, **eps_kw))
    lam = np.where(active, R / max(active.sum(), 1), 0.0)
    mu = np.full(N, R * b / N)
    hist = []
    prev_obj = np.inf
    it = 0
    for it in range(1, max_iter + 1):
        s_mt = float(np.sum(mu * t_cmp))
        s_lt = float(np.sum(lam * tau))
        a, b = _stationarity_solve(problem, s_mt, s_lt, T, a, b)
        if constrain_mu:
            b = max(b, b_min_for_mu(problem, a))
        tau = delay.edge_round_time(problem, assoc, a)
        T = delay.cloud_round_time(problem, assoc, a, b)
        R = float(delay.cloud_rounds(a, b, **eps_kw))
        # KKT-consistent multipliers: concentrate on bottlenecks
        # (complementary slackness), totals from the slack stationarity.
        edge_load = b * tau + np.where(active, t_mc, 0.0)
        w_edge = softmax(np.where(active, edge_load, -np.inf), temp * T)
        lam_t = R * w_edge
        ue_load = a * t_cmp + t_com
        mu_t = np.zeros(N)
        for m in range(M):
            members = edge_of == m
            if not members.any():
                continue
            w_ue = softmax(ue_load[members], temp * max(tau[m], 1e-12))
            mu_t[members] = lam_t[m] * b * w_ue
        lam = (1 - eta) * lam + eta * lam_t
        mu = (1 - eta) * mu + eta * mu_t
        obj = objective(problem, assoc, a, b)
        if record_history:
            hist.append((a, b, obj))
        if abs(prev_obj - obj) <= tol * max(abs(obj), 1.0):
            break
        prev_obj = obj
    ai, bi, v = _round_best(problem, assoc, a, b, constrain_mu)
    r = float(delay.cloud_rounds(ai, bi, **eps_kw))
    return IterSolution(a=a, b=b, a_int=ai, b_int=bi, total=v,
                        total_relaxed=objective(problem, assoc, a, b),
                        rounds=r, iters=it, history=hist if record_history else None)
