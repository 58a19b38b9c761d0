"""Fault processes for the HFL delay model — BEYOND-PAPER, ported from the
JAX package's ``repro/core/faults.py``.

Each process is independently optional, validated in ``__post_init__``,
has an ``is_null()`` fast path and draws ONE keyed batch per run on the
key protocol of ``repro_torch.core.stochastic`` (the same splits as the
reference, so the reference's variates fed through a key adapter give
the same masks, attempt counts and windows):

* ``BernoulliDropout`` — iid per-cycle UE unavailability.
* ``MarkovChurn``      — two-state (Gilbert) on/off churn with sticky
  availability; stationary unavailability ``p_off / (p_off + p_on)``.
* ``UplinkLoss``       — per-attempt loss of the eq. 4 upload: geometric
  attempt counts from one uniform per upload, each retransmission charged
  into eq. 5 time plus capped exponential backoff.
* ``EdgeOutage``       — per-cycle edge-server failure with exponential
  repair durations, materialized as wall-clock ``(edge, t_fail,
  t_repair)`` windows.

``FaultModel`` composes them; ``SCENARIOS``' ``ue_churn``,
``edge_outage`` and ``lossy_uplink`` carry one.

Only the processes are ported.  The handling policy (``FaultPolicy``,
``faulty_cycle_stats``, ``FaultCycleSource``) and the fault-aware
makespans of ``core.delay`` wait for ROADMAP Queue 1 item 9.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import delay
from repro_torch.core.problem import HFLProblem

WAIT_FOR_ALL = "wait_for_all"
DEADLINE_FAILOVER = "deadline_failover"

_BACKOFF_EXP_CAP = 10       # caps the 2^k backoff growth (real stacks do)


@dataclasses.dataclass(frozen=True)
class BernoulliDropout:
    """iid per-cycle UE unavailability: ``P(UE absent in a cycle) = rate``.

    An absent UE skips the WHOLE cycle (all b edge rounds).
    """
    rate: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"dropout rate must be in [0, 1], "
                             f"got {self.rate}")

    def is_null(self) -> bool:
        return self.rate <= 0.0

    def sample_available(self, key, num_cycles: int, num_ues: int):
        """(C, N) bool availability — one batched draw."""
        if self.is_null():
            return torch.ones((num_cycles, num_ues), dtype=torch.bool,
                              device=key.device)
        return key.uniform((num_cycles, num_ues)) >= self.rate


@dataclasses.dataclass(frozen=True)
class MarkovChurn:
    """Two-state on/off churn: sticky availability (Gilbert model).

    Per cycle an ON UE turns OFF with ``p_off`` and an OFF UE returns with
    ``p_on``; the initial state is drawn from the stationary distribution,
    so the long-run unavailability is ``p_off / (p_off + p_on)``.
    """
    p_off: float = 0.1
    p_on: float = 0.5

    def __post_init__(self):
        if not (0.0 <= self.p_off <= 1.0 and 0.0 < self.p_on <= 1.0):
            raise ValueError(f"need 0 <= p_off <= 1 and 0 < p_on <= 1, "
                             f"got p_off={self.p_off}, p_on={self.p_on}")

    def is_null(self) -> bool:
        return self.p_off <= 0.0

    def sample_available(self, key, num_cycles: int, num_ues: int):
        """(C, N) bool availability — a loop over cycles, vectorized over
        UEs (the reference's ``lax.scan``)."""
        if self.is_null():
            return torch.ones((num_cycles, num_ues), dtype=torch.bool,
                              device=key.device)
        k0, ku = key.split()
        pi_off = self.p_off / max(self.p_off + self.p_on, 1e-12)
        state = k0.uniform((num_ues,)) >= pi_off
        u = ku.uniform((num_cycles, num_ues))
        avail = torch.empty(u.shape, dtype=torch.bool, device=u.device)
        for c in range(u.shape[0]):
            state = torch.where(state, u[c] >= self.p_off, u[c] < self.p_on)
            avail[c] = state
        return avail


@dataclasses.dataclass(frozen=True)
class UplinkLoss:
    """Per-attempt loss of the eq. 4 UE->edge upload, with backoff.

    Attempts until success are geometric, drawn from ONE uniform per
    upload (``attempts = floor(log u / log rate) + 1``).  ``k`` attempts
    charge ``(k - 1)`` extra eq. 5 transmissions plus
    ``backoff * (2^(k-1) - 1)`` seconds of idle (growth capped at
    ``2^10``).
    """
    rate: float = 0.0
    backoff: float = 0.05

    def __post_init__(self):
        # rate=1 would mean NO upload ever succeeds (infinite attempts)
        if not 0.0 <= self.rate < 1.0:
            raise ValueError(f"loss rate must be in [0, 1), "
                             f"got {self.rate}")
        if self.backoff < 0:
            raise ValueError("backoff must be >= 0")

    def is_null(self) -> bool:
        return self.rate <= 0.0

    def sample_attempts(self, key, shape):
        """Geometric attempt counts (>= 1, int32), one uniform per upload."""
        if self.is_null():
            return torch.ones(tuple(shape), dtype=torch.int32,
                              device=key.device)
        u = key.uniform(shape, minval=1e-12, maxval=1.0)
        log_rate = torch.log(torch.tensor(self.rate, dtype=torch.float32,
                                          device=u.device))
        att = torch.floor(torch.log(u) / log_rate) + 1.0
        return att.to(torch.int32)

    def total_backoff(self, attempts):
        """Cumulative backoff idle charged before the successful attempt."""
        k = torch.clamp(torch.as_tensor(attempts).to(torch.float32) - 1.0,
                        0.0, float(_BACKOFF_EXP_CAP))
        return self.backoff * (torch.exp2(k) - 1.0)


@dataclasses.dataclass(frozen=True)
class EdgeOutage:
    """Edge-server outages: per-cycle failures with exponential repair.

    Each cycle slot of each edge fails with probability ``rate`` at a
    uniform phase inside the slot; the repair lasts ``repair_cycles *
    Exp(1)`` deterministic cycle times.  Windows are materialized once per
    run as wall-clock ``(edge, t_fail, t_repair)`` tuples, overlaps
    merged, sorted by failure time.
    """
    rate: float = 0.0
    repair_cycles: float = 1.5

    def __post_init__(self):
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"outage rate must be in [0, 1], "
                             f"got {self.rate}")
        if self.repair_cycles <= 0:
            raise ValueError("repair_cycles must be > 0")

    def is_null(self) -> bool:
        return self.rate <= 0.0

    def sample_windows(self, key, problem: HFLProblem, assoc, a, b,
                       num_cycles: int) -> List[Tuple[int, float, float]]:
        if self.is_null():
            return []
        det = delay.edge_cycle_time(problem, np.asarray(assoc), a, b)
        kh, kp, kd = key.split(3)
        C, M = int(num_cycles), problem.num_edges
        hit = (kh.uniform((C, M)) < self.rate).cpu().numpy()
        phase = kp.uniform((C, M)).cpu().numpy()
        dur = kd.exponential((C, M)).cpu().numpy() * self.repair_cycles
        windows: List[Tuple[int, float, float]] = []
        for m in range(M):
            if det[m] <= 0:
                continue                            # inactive edge
            merged: List[List[float]] = []
            for c in np.flatnonzero(hit[:, m]):
                f = float((c + phase[c, m]) * det[m])
                r = f + float(dur[c, m] * det[m])
                if merged and f <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], r)
                else:
                    merged.append([f, r])
            windows.extend((m, f, r) for f, r in merged)
        return sorted(windows, key=lambda w: (w[1], w[0]))


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Composition of the three fault processes (each optional).

    ``is_null()`` is the parity guarantee: a null model leaves every
    consumer on its fault-free path.
    """
    dropout: Optional[object] = None      # BernoulliDropout | MarkovChurn
    loss: Optional[UplinkLoss] = None
    outage: Optional[EdgeOutage] = None

    def is_null(self) -> bool:
        return all(p is None or p.is_null()
                   for p in (self.dropout, self.loss, self.outage))
