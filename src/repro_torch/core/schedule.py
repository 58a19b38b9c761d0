"""HFL schedule — the paper's technique as a first-class framework feature.

An ``HFLSchedule`` is the full output of the paper's pipeline: the
association chi (Alg. 3), the iteration counts (a*, b*) (Alg. 2 / direct
convex solve) and the derived round structure.  The FL runtime
(``repro_torch.fl``) executes any schedule.

Copied from the JAX package's ``repro/core/schedule.py``: ``HFLSchedule``,
``plan``, ``plan_joint`` (the stochastic joint optimizer's pipeline;
``device=`` places an int key's draws) and the hardware adaptation,
``problem_from_roofline`` and ``plan_from_roofline``: a step's roofline
terms on an H100 cluster (``repro_torch.roofline``) as the paper's
wireless network.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core import assoc as assoc_lib
from repro_torch.core import delay, iteropt
from repro_torch.core.problem import HFLProblem
from repro_torch.launch.mesh import IB_BW, NVLINK_BW


@dataclasses.dataclass
class HFLSchedule:
    """Everything the runtime needs to execute hierarchical FL."""

    a: int                       # local iterations per edge round (eq. 2)
    b: int                       # edge rounds per cloud round (eq. 7)
    rounds: int                  # cloud rounds R(a,b,eps) (eq. 15)
    assoc: np.ndarray            # (N, M) 0/1 UE-to-edge association
    total_delay: float           # objective value R*T (eq. 13)
    cloud_round_time: float      # T (eq. 34)
    edge_round_time: np.ndarray  # tau_m (eq. 33)
    problem: Optional[HFLProblem] = None
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def num_edges(self) -> int:
        return self.assoc.shape[1]

    @property
    def num_ues(self) -> int:
        return self.assoc.shape[0]

    def groups(self):
        """List of per-edge UE index arrays."""
        return [np.flatnonzero(self.assoc[:, m]) for m in range(self.num_edges)]

    def total_local_steps(self) -> int:
        """Local GD steps each UE runs over the whole job: R * b * a."""
        return self.rounds * self.b * self.a

    def sync_points(self):
        """(edge_every, cloud_every) in local-step units (Alg. 1 lines 9/14)."""
        return self.a, self.a * self.b


def plan(problem: HFLProblem, *, association: str = "proposed",
         solver: str = "direct", seed: int = 0) -> HFLSchedule:
    """End-to-end paper pipeline: Alg. 3 association, then sub-problem I."""
    assoc = assoc_lib.STRATEGIES[association](problem, seed=seed)
    sol = (iteropt.solve_direct if solver == "direct"
           else iteropt.solve_dual)(problem, assoc)
    bd = delay.objective_breakdown(problem, assoc, sol.a_int, sol.b_int)
    return HFLSchedule(
        a=sol.a_int, b=sol.b_int,
        rounds=max(1, int(math.ceil(sol.rounds))),
        assoc=assoc, total_delay=bd["total"],
        cloud_round_time=bd["T"], edge_round_time=bd["tau"],
        problem=problem,
        meta={"association": association, "solver": solver,
              "a_relaxed": sol.a, "b_relaxed": sol.b,
              "theta": bd["theta"], "mu": bd["mu"]},
    )


def plan_joint(problem: HFLProblem, *, scenario: str = "urban_stragglers",
               association: str = "proposed", seed: int = 0,
               q: float = 0.95, num_trials: int = 16, key=0, device=None,
               **joint_kw) -> HFLSchedule:
    """Stochastic joint pipeline: association, then ``jointopt.solve_joint``.

    Beyond-paper counterpart of ``plan``: (a, b) come from the
    q-quantile time-to-target under the named scenario jointly with
    ``max_staleness`` and the per-cell bandwidth split, which is APPLIED
    to ``problem.bandwidth_frac`` so the runtime's eq. 4/5 rates (and
    every stochastic draw) price the optimized split.  The winning
    staleness bound rides in ``meta["max_staleness"]`` —
    ``HFLSimulator(..., mode="async", max_staleness=None)`` picks it up.
    An int ``key`` draws on ``device`` (``None``: the card; the
    ``"deterministic"`` scenario draws nothing).
    """
    from repro_torch.core import jointopt

    assoc = assoc_lib.STRATEGIES[association](problem, seed=seed)
    sol = jointopt.solve_joint(problem, assoc, model=scenario, q=q,
                               num_trials=num_trials, key=key, device=device,
                               **joint_kw)
    if sol.bandwidth_frac is not None:
        problem.bandwidth_frac = sol.bandwidth_frac
    bd = delay.objective_breakdown(problem, assoc, sol.a, sol.b)
    return HFLSchedule(
        a=sol.a, b=sol.b,
        rounds=max(1, int(sol.rounds)),
        assoc=assoc, total_delay=bd["total"],
        cloud_round_time=bd["T"], edge_round_time=bd["tau"],
        problem=problem,
        meta={"association": association, "solver": "joint",
              "scenario": scenario, "max_staleness": sol.max_staleness,
              "objective_q": sol.q, "objective": sol.objective,
              "bandwidth": sol.bandwidth,
              "theta": bd["theta"], "mu": bd["mu"]},
    )


# ---------------------------------------------------------------------------
# Hardware adaptation: an H100 cluster as the "wireless network"
# ---------------------------------------------------------------------------

def problem_from_roofline(roofline: dict, *, num_edges: int, ues_per_edge: int,
                          model_bytes: float, epsilon: float = 0.25,
                          zeta: float = 5.0, gamma: float = 5.0,
                          ici_bw: float = NVLINK_BW, dcn_bw: float = IB_BW,
                          het_spread: float = 0.15, seed: int = 0) -> HFLProblem:
    """Map a step's roofline terms onto an HFLProblem.

    The paper's network on an H100 cluster: a UE is one GPU, an edge is
    one NVLink node (its GPUs average over NVLink), the cloud is the
    InfiniBand fabric between the nodes.

    * UE's per-local-step compute time <-> the roofline compute+memory
      bound (whichever dominates on the GPU).
    * UE->edge upload <-> the node's parameter all-reduce: bytes/NVLink
      (``ici_bw``, the reference's name; the NVLink rate each way).
    * edge->cloud upload <-> the reduce across nodes: bytes/InfiniBand
      (``dcn_bw``; one ConnectX-7 a GPU, each way).

    Heterogeneity (the paper's f_n, g_{n,m} spread) is simulated with a
    +-het_spread lognormal jitter, as real clusters see from host skew.
    """
    t_step = max(roofline["compute_s"], roofline["memory_s"])
    t_sync_edge = model_bytes / ici_bw
    t_sync_cloud = model_bytes / dcn_bw

    n = num_edges * ues_per_edge
    prob = HFLProblem(num_edges=num_edges, num_ues=n, epsilon=epsilon,
                      zeta=zeta, gamma=gamma, seed=seed)
    rng = np.random.default_rng(seed)
    jit = np.exp(rng.normal(0.0, het_spread, n))
    # Override the wireless constants with GPU-derived ones: t_cmp via
    # cycles/f ratio, t_com via a synthetic rate that reproduces bytes/bw.
    prob.cycles = t_step * jit * prob.f_max / np.maximum(prob.samples, 1.0)
    prob.model_bits = 8.0 * model_bytes
    prob.edge_model_bits = 8.0 * model_bytes
    # Channel such that the equal-split rate equals the NVLink rate:
    # set B = 8*ici_bw*ues_per_edge [bit/s of capacity] and SNR = 1 so that
    # r_{n,m} = (B/|N_m|) * log2(2) = 8*ici_bw  =>  t_com = bytes/ici_bw.
    # Per-UE heterogeneity rides on the SNR (2^jit - 1 keeps rate ∝ jit).
    prob.bandwidth_total = 8.0 * ici_bw * ues_per_edge
    jit_g = np.exp(rng.normal(0.0, het_spread, n))
    snr = 2.0 ** jit_g - 1.0
    prob.gains = (snr * prob.noise_power / prob.p_max)[:, None] * \
        np.ones((1, num_edges))
    jit_m = np.exp(rng.normal(0.0, het_spread, num_edges))
    prob.backhaul = prob.edge_model_bits / (t_sync_cloud * jit_m)
    prob.meta = {"t_step": t_step, "t_sync_edge": t_sync_edge,
                 "t_sync_cloud": t_sync_cloud}
    return prob


def plan_from_roofline(roofline: dict, *, num_edges: int = 2,
                       ues_per_edge: int = 16, model_bytes: float = 4e9,
                       **kw) -> HFLSchedule:
    """A step's roofline terms -> the optimal (a, b, chi) local-SGD
    schedule for the GPU cluster (UE = GPU, edge = NVLink node, cloud =
    InfiniBand); ``kw`` goes to ``problem_from_roofline``."""
    prob = problem_from_roofline(roofline, num_edges=num_edges,
                                 ues_per_edge=ues_per_edge,
                                 model_bytes=model_bytes, **kw)
    return plan(prob)
