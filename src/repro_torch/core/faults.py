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

Failure handling (``FaultPolicy``):

* ``wait_for_all``      — the naive baseline: no deadline, effectively
  unbounded retries, outages stall the fleet in place.
* ``deadline_failover`` — a per-edge round deadline ``D_m =
  deadline_factor * tau_m`` (deterministic eq. 33) cuts the UEs that miss
  it (optionally relaxed until ``min_deliver_frac`` of the available
  cohort delivers), retries are capped at ``max_retries``, and edge
  outages are survived by failover (the event engine voids in-flight
  cycles and ``core.assoc.failover`` re-homes the orphans).

``faulty_cycle_stats`` is the one sampling entry point: under one key it
draws the delay ingredients through the ``DelayModel`` hooks and the
fault processes and returns per-cycle cycle times, survivor masks,
delivered fractions, outage windows and stall charges, all that
``core.delay.faulty_async_completion`` and ``fl.sim`` need.  The float32
per-UE arithmetic and eq. 33's member max run on the key's device; the
policy logic (the come-back wait, the over-selection floor, the deadline
mask, the outage view) stays float64 numpy on the host, as in the
reference.  ``FaultCycleSource`` is its key-offset, replay-stable view.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
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


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """How the protocol HANDLES the injected faults.

    * ``name=WAIT_FOR_ALL`` — the naive baseline: infinite deadline,
      effectively unbounded retries, outages stall the fleet in place
      (their repair time is charged to the affected cycle).
    * ``name=DEADLINE_FAILOVER`` (default) — per-edge round deadline
      ``D_m = deadline_factor * tau_m`` (deterministic eq. 33), capped
      retries, and edge failover (in-flight cycles voided, down edges
      excluded from the staleness floor, orphans re-associated via
      ``assoc.failover``).
    * ``min_deliver_frac`` — over-selection: the deadline is relaxed per
      EDGE ROUND until at least this fraction of the available cohort
      makes that round.  (Cycle-level survivorship — all ``b`` rounds —
      can still be lower, since each round's loss draws are independent.)
    """
    name: str = DEADLINE_FAILOVER
    deadline_factor: float = float("inf")
    max_retries: int = 10 ** 9
    failover: bool = False
    min_deliver_frac: float = 0.0

    def __post_init__(self):
        if self.name not in (WAIT_FOR_ALL, DEADLINE_FAILOVER):
            raise ValueError(f"unknown fault policy {self.name!r}; expected "
                             f"{WAIT_FOR_ALL!r} or {DEADLINE_FAILOVER!r}")
        if self.deadline_factor <= 0:
            raise ValueError("deadline_factor must be > 0")
        if not 0.0 <= self.min_deliver_frac <= 1.0:
            raise ValueError("min_deliver_frac must be in [0, 1]")


def wait_for_all_policy() -> FaultPolicy:
    """The naive baseline: wait forever, retry forever, stall on outage."""
    return FaultPolicy(name=WAIT_FOR_ALL)


def deadline_failover_policy(deadline_factor: float = 1.5,
                             max_retries: int = 2,
                             min_deliver_frac: float = 0.5) -> FaultPolicy:
    """The failure-aware protocol with sane defaults."""
    return FaultPolicy(name=DEADLINE_FAILOVER,
                       deadline_factor=deadline_factor,
                       max_retries=max_retries, failover=True,
                       min_deliver_frac=min_deliver_frac)


@dataclasses.dataclass
class FaultyCycles:
    """Everything one faulty run needs, sampled under one key (host
    numpy).

    * ``cycle_times``    — (C, M) float64 policy-adjusted per-cycle times
      (the deadline caps each round at ``D_m``; retries and backoff are
      charged in).  Outage stalls are NOT included: ``stall`` carries them
      for barrier-style consumers, the event engine re-derives them from
      ``windows``.
    * ``survivors``      — (C, N) bool: UE delivered every round of the
      cycle (available, within the retry cap, within the deadline).
    * ``delivered_frac`` — (C, M) delivered weight fraction per edge, 0
      where nothing arrived.
    * ``windows``        — wall-clock ``(edge, t_fail, t_repair)`` outage
      windows for ``events.simulate_async``.
    * ``down``           — (C, M) bool: the edge's cycle slot intersects an
      outage window.
    * ``stall``          — (C, M) repair time charged to the cycle whose
      slot holds the failure (``wait_for_all`` barrier consumers add it).
    """
    cycle_times: np.ndarray
    survivors: np.ndarray
    delivered_frac: np.ndarray
    windows: List[Tuple[int, float, float]]
    down: np.ndarray
    stall: np.ndarray


def faulty_cycle_stats(fault_model: FaultModel, policy: FaultPolicy, key,
                       problem: HFLProblem, assoc, a, b, num_cycles: int,
                       delay_model=None, device=None) -> FaultyCycles:
    """Sample ``num_cycles`` fault-adjusted cycles in one batched draw.

    Delay ingredients come from ``delay_model``'s hooks (default: the
    paper's deterministic values), faults from ``fault_model``, handling
    from ``policy``, all under one key (``device`` places an int seed), so
    two policies evaluated at the same key see the SAME draws (common
    random numbers: the deadline policy's cycle times are pointwise <=
    wait-for-all's).
    """
    from repro_torch.core import stochastic
    if delay_model is None:
        delay_model = stochastic.DelayModel()
    A = np.asarray(assoc)
    C, b = int(num_cycles), int(b)
    N, M = problem.num_ues, problem.num_edges
    key = stochastic.ensure_key(key, device)
    kc, ku, kb, kd, kl, ko = key.split(6)

    # -- ingredient draws (per-UE, per-round; float32 on the device) --------
    t_cmp = delay_model.sample_compute(kc, problem, C * b)
    t_up = delay_model.sample_uplink(ku, problem, A, C * b)
    t_mc = delay_model.sample_backhaul(kb, problem, C).cpu().numpy()
    dev = t_cmp.device

    # -- fault draws --------------------------------------------------------
    dropout = fault_model.dropout or BernoulliDropout(0.0)
    loss = fault_model.loss or UplinkLoss(0.0)
    outage = fault_model.outage or EdgeOutage(0.0)
    avail = dropout.sample_available(kd, C, N)                  # (C, N)
    attempts = loss.sample_attempts(kl, (C * b, N))             # (C*b, N)

    max_attempts = int(policy.max_retries) + 1
    att_eff = torch.clamp(attempts, max=max_attempts)
    ok_loss = (attempts <= max_attempts).reshape(C, b, N)

    per_ue = (torch.tensor(a, dtype=torch.float32, device=dev) * t_cmp +
              att_eff.to(torch.float32) * t_up +
              loss.total_backoff(att_eff)).reshape(C, b, N)

    # -- deadline (eq. 33 capped at D_m) ------------------------------------
    det_tau = delay.edge_round_time(problem, A, a)              # (M,)
    gid = np.where(A.sum(1) > 0, A.argmax(1), M)                # overflow M
    avail3 = avail[:, None, :]
    if policy.name == WAIT_FOR_ALL and not dropout.is_null():
        # The naive policy WAITS for churned-out UEs: an absent UE stalls
        # its edge until it next comes back (the run length of its OFF
        # streak, in deterministic cycle times), then delivers.  The wait
        # only ADDS time, so the deadline policy's cycle times stay
        # pointwise <= the naive ones under common random numbers.
        avail_np = avail.cpu().numpy()
        comeback = np.zeros((C, N))
        run = np.ones(N)                  # OFF-streak length past horizon
        for c in range(C - 1, -1, -1):
            run = np.where(avail_np[c], 0.0, run + 1.0)
            comeback[c] = run
        det_cyc = delay.edge_cycle_time(problem, A, a, b)
        cyc_of_ue = np.concatenate([det_cyc, [0.0]])[gid]       # (N,)
        wait = comeback * cyc_of_ue[None, :] / max(b, 1)        # per round
        per_ue = per_ue + torch.as_tensor(wait[:, None, :],
                                          dtype=torch.float32, device=dev)
        avail3 = torch.ones_like(avail3)  # everyone (eventually) delivers
    masked = torch.where(avail3, per_ue, 0.0)
    tau = stochastic._segment_max(masked.reshape(C * b, N), A)  # (C*b, M)
    tau = tau.cpu().numpy().reshape(C, b, M)
    avail3 = avail3.cpu().numpy()
    per_ue_np = per_ue.cpu().numpy()
    deadline = np.where(np.isfinite(policy.deadline_factor),
                        policy.deadline_factor * det_tau, np.inf)
    if policy.min_deliver_frac > 0 and np.isfinite(deadline).any():
        # Over-selection: never cut below the q-th fastest available
        # member — relax D_m per round to that member's time (float64
        # numpy, as the reference: the floor sets the deadline).
        q = float(policy.min_deliver_frac)
        t_np = np.where(avail3, per_ue_np, np.nan)
        floor_d = np.zeros((C, b, M))
        for m in range(M):
            mem = np.flatnonzero(gid == m)
            if mem.size == 0:
                continue
            with warnings.catch_warnings():
                # all-NaN slices (every member absent) resolve to 0.0
                warnings.simplefilter("ignore", RuntimeWarning)
                floor_d[:, :, m] = np.nan_to_num(
                    np.nanquantile(t_np[:, :, mem], q, axis=2), nan=0.0)
        D = np.maximum(deadline[None, None, :], floor_d)        # (C, b, M)
    else:
        D = np.broadcast_to(deadline[None, None, :], (C, b, M))
    tau = np.minimum(tau, np.where(np.isfinite(D), D, np.inf))

    d_of_ue = np.take(np.concatenate([D, np.full((C, b, 1), np.inf)],
                                     axis=2), gid, axis=2)      # (C, b, N)
    delivered = (avail3 & ok_loss.cpu().numpy() & (per_ue_np <= d_of_ue) &
                 (gid < M)[None, None, :])
    survivors = delivered.all(axis=1)                           # (C, N)

    active = A.sum(0) > 0
    cycle_times = tau.sum(axis=1) + np.where(active, t_mc, 0.0)  # (C, M)

    # -- outage windows + their cycle-index view ----------------------------
    windows = outage.sample_windows(ko, problem, A, a, b, C)
    down = np.zeros((C, M), dtype=bool)
    stall = np.zeros((C, M))
    det_cycle = delay.edge_cycle_time(problem, A, a, b)
    for m, f, r in windows:
        step = max(float(det_cycle[m]), 1e-12)
        c0 = min(int(f // step), C - 1)
        c1 = min(int(math.ceil(r / step)), C)
        down[c0:max(c1, c0 + 1), m] = True
        # repair duration plus the voided in-flight work, which the naive
        # baseline redoes after repair
        stall[c0, m] += (r - f) + (f - c0 * step)

    # -- delivered weight fraction per edge ---------------------------------
    w = np.asarray(problem.samples, float)
    w_tot = np.zeros(M)
    np.add.at(w_tot, gid[gid < M], w[gid < M])
    w_surv = np.zeros((C, M))
    src = survivors * w[None, :]
    for m in range(M):
        mem = np.flatnonzero(gid == m)
        if mem.size:
            w_surv[:, m] = src[:, mem].sum(axis=1)
    delivered_frac = np.divide(w_surv, np.maximum(w_tot, 1e-12)[None, :],
                               out=np.zeros_like(w_surv),
                               where=w_tot[None, :] > 0)
    return FaultyCycles(cycle_times=cycle_times, survivors=survivors,
                        delivered_frac=delivered_frac, windows=windows,
                        down=down, stall=stall)


class FaultCycleSource:
    """Lazy, replay-stable view of the infinite faulty-cycle timeline.

    Chunk ``i`` is ``faulty_cycle_stats`` under ``key.fold_in(i)`` with
    ``num_cycles=block`` (``stochastic.CYCLE_BLOCK`` by default), so cycle
    ``c``'s cost row and survivor mask are pure functions of ``(key, c //
    block)``, whatever was drawn before, and each chunk's rows equal a
    direct call at that chunk's key byte for byte.

    Outage windows are NOT drawn here (the stored model has
    ``outage=None``): windows are wall-clock, so a consumer draws one set
    over a fixed horizon and hands it to the event engine.  Chunking also
    truncates fault memory at chunk edges (``MarkovChurn`` streaks restart
    from the stationary law, the naive policy's come-back wait looks ahead
    only to the chunk's end) — the price of resume stability.
    """

    def __init__(self, fault_model: FaultModel, policy: FaultPolicy, key,
                 problem: HFLProblem, assoc, a, b, delay_model=None,
                 block: Optional[int] = None, device=None):
        from repro_torch.core import stochastic
        self.fault_model = dataclasses.replace(fault_model, outage=None)
        self.policy = policy
        self.key = stochastic.ensure_key(key, device)
        self.problem = problem
        self.assoc = np.asarray(assoc)
        self.a, self.b = a, b
        self.delay_model = delay_model
        self.block = int(stochastic.CYCLE_BLOCK if block is None else block)
        if self.block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        self._chunks: dict = {}

    def stats(self, chunk: int) -> FaultyCycles:
        """The ``block`` cycles of key-offset ``chunk`` (cached)."""
        chunk = int(chunk)
        if chunk not in self._chunks:
            self._chunks[chunk] = faulty_cycle_stats(
                self.fault_model, self.policy, self.key.fold_in(chunk),
                self.problem, self.assoc, self.a, self.b, self.block,
                delay_model=self.delay_model)
            if len(self._chunks) > 8:
                # the SSP gate bounds how far back a replay reaches; old
                # chunks are pure re-draws anyway
                for c in sorted(self._chunks)[:-4]:
                    del self._chunks[c]
        return self._chunks[chunk]

    def cycle_row(self, c: int) -> np.ndarray:
        """(M,) policy-adjusted cost row of 0-based cycle ``c``."""
        chunk, off = divmod(int(c), self.block)
        return self.stats(chunk).cycle_times[off]

    def survivor_row(self, c: int) -> np.ndarray:
        """(N,) bool UE survivor mask of 0-based cycle ``c``."""
        chunk, off = divmod(int(c), self.block)
        return self.stats(chunk).survivors[off]
