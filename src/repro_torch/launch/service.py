"""Crash-tolerant always-on HFL control plane — BEYOND-PAPER, ported from
the JAX package's ``repro/launch/service.py``.

The paper's pipeline (and the repo's batch benchmarks) is a BATCH
job: plan a schedule, simulate R rounds, exit.  Real FL deployments run
the other way around — the control plane is a long-lived SERVICE that
ingests edge arrivals forever, survives crashes, and keeps its latency
SLO under load it did not choose.  ``HFLService`` turns the repo's async
engine + flat-buffer simulator into exactly that:

* **Live traffic.**  The arrival process is the event-driven engine
  (``core.events.AsyncEngine``) driven by a REPLAYED trace of scenario
  segments: each :class:`Segment` names a ``core.stochastic`` scenario
  (its ``DelayModel`` prices the cycle draws) plus a load multiplier —
  a 4x burst divides every cycle time by 4, so arrivals land 4x as
  fast.  Segments switch live at their simulated-time epochs; draws are
  key-offset chunked (``stochastic.CycleTimeSource``), so a resumed
  process re-prices every cycle bit-identically without replaying the
  consumed prefix.

* **A cloud merge queue.**  The paper's cloud aggregation is free; a
  real parameter server is not.  Every engine delivery enqueues a merge
  JOB (the edge's eq. 6 mean row + its aggregation mass) into a FIFO
  queue served at ``merge_cost`` simulated seconds per merge (default:
  half the mean deterministic cycle time / M — ~50% utilization at
  load 1).  A job's merge publishes into the cloud vector when its
  SERVICE completes, with staleness = the engine version lag at arrival
  plus any merges applied while it queued.  Cycle latency (the SLO
  metric) is ``service finish - cycle departure``.

* **Overload shedding.**  When the backlog crosses ``backlog_high``
  the service degrades: the engine's SSP gate tightens to
  ``degraded_staleness`` (fast edges stop running ahead), the
  lowest-mass queued jobs are DROPPED (never the in-service head), and
  departure waves shed the lowest-weight ``ue_shed_frac`` of each
  cohort via mass-preserving survivor re-weighting
  (``aggregate.survivor_weights`` — eq. 6 stays the unbiased mean of
  the participants).  Recovery at ``backlog_low`` restores everything.

* **Durable checkpoints.**  Every ``ckpt_every`` applied events the
  FULL control-plane state — flat UE buffer, published cloud vector,
  engine snapshot, merge queue (rows included), service clocks, SLO
  accumulators, trace — is written atomically through
  ``checkpoint.save_pytree`` (tmp + fsync + rename).  ``kill -9`` at
  ANY point loses at most the events since the last checkpoint;
  ``restore_latest`` falls back through older checkpoints if the newest
  is damaged, validates the config echo, and the resumed run reproduces
  the uninterrupted run's event trace exactly and its model to float32
  re-execution tolerance (<= 1e-6).  ``keep_last_k`` compacts the
  cadence directory after each save (``checkpoint.gc_checkpoints``,
  delete-newest-last so a crash mid-GC never moves the restore
  frontier).

* **Live faults.**  ``fault_model=`` threads the fault layer
  (``core.faults``) through the running control plane: per-cycle UE
  dropout/churn and retry-capped uplink loss are drawn through a
  key-offset-chunked ``faults.FaultCycleSource`` (policy-adjusted cycle
  costs price the engine's departures; per-cycle survivor masks compose
  with the shed/sampling masks under ONE ``survivor_weights``
  renormalization — byte-identical per chunk to the batch
  ``faulty_cycle_stats`` semantics, dead-and-shed cohorts contribute
  exact zero, never NaN).
  Edge-outage windows are materialized once over a fixed horizon and
  handed to the engine, which VOIDS in-flight cycles (``fail`` /
  ``repair`` trace records) and — under the deadline-failover policy —
  excludes down edges from the SSP staleness floor; a cohort whose
  survivors all died has its arrival dropped at the cloud
  (``shed-fault`` records) instead of publishing a zero row; at segment
  boundaries that fall inside an outage window the orphaned UEs
  re-associate onto surviving edges via ``assoc.failover`` for delay
  pricing (``failover`` records).  All fault draws are pure in
  ``(fault_seed, cycle)``, so crash-resume replays every fault decision
  bit-identically with nothing extra in the checkpoint.

Port notes.  The control plane is host numpy, as in the reference: the
published cloud vector ``g`` is a host float32 array and every merge is
one numpy update.  The model side runs on the simulator's device: each
departure wave is one ``replay_departure`` (K1 on the card), each merge
reads its edge's row back to the host, and with ``merge_stream_chunk > 0``
the cohort's rows fold through a ``StreamingEdgeAccumulator`` on the
simulator's device (K4 on the card, one launch per chunk) without leaving
it.  Where the reference folds its random keys, the port folds the
``stochastic.Key`` that one method per stream returns (``_delay_key``,
``_fault_key``, ``_sample_key``, on the simulator's device).  The
checkpoint tree, its schema version and the trace records are the
reference's, field for field.

On a mesh of ranks (a simulator built with ``mesh=``) every rank runs
the same service: the control plane is deterministic, reads the
simulator's global padded weights and group ids (``_hot_weights``,
``_hot_gids``) as the reference does, and calls the simulator's hooks in
the same order on every rank, which make their results global (an
all-reduce over 'data', an all-gather over 'model').  The streaming merge
folds the gathered cohort rows on each rank.  Only rank 0 writes a
checkpoint (every rank writing the same temporary file at once would
race); the others wait for it, and every rank reads it on resume.

Minimal lifecycle::

    sim = default_service_sim(num_ues=24, num_edges=4, max_staleness=4,
                              device="cuda")
    svc = HFLService(sim, ServiceConfig(
        segments=(Segment("iid_campus", 1.0, 200.0),
                  Segment("urban_stragglers", 4.0, 100.0),
                  Segment("iid_campus", 1.0, float("inf"))),
        ckpt_dir="ckpts", ckpt_every=50))
    svc.run(max_updates=400)        # crash here, then ...
    svc2 = HFLService(default_service_sim(..., device="cuda"),
                      same_config)
    svc2.restore_latest()           # ... resume from the newest ckpt
    svc2.run(max_updates=400)       # identical trace, same final model
    print(svc2.summary())           # p50/p95, shed_frac, ckpt overhead
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch.distributed as dist

from repro_torch.checkpoint import (CheckpointError, gc_checkpoints,
                                    list_checkpoints, load_pytree,
                                    save_pytree)
from repro_torch.core import assoc as assoc_lib
from repro_torch.core import delay as delay_lib
from repro_torch.core import events
from repro_torch.core import faults as faults_lib
from repro_torch.core import stochastic

#: Service checkpoint + trace schema version (see ``checkpoint.npz``'s
#: module docstring for the on-disk tree), the JAX package's — bump on any
#: layout change.  v2: in-flight fault bookkeeping ("dead" tree) +
#: fault/GC counters in "svc".
SERVICE_CKPT_VERSION = 2
SERVICE_TRACE_SCHEMA = "hfl-service-trace"
#: v2: fault record kinds (fail/repair/shed-fault/failover),
#: merge records carry their published mass, ckpt records their GC count.
SERVICE_TRACE_VERSION = 2

#: Every record kind a version-2 service trace may carry — the loader
#: validates each record against this set, so a foreign/corrupt export
#: fails loudly instead of silently skipping unknown events.
SERVICE_TRACE_KINDS = frozenset({
    "merge",       # one cloud publish (latency/backlog/stale/mass)
    "shed",        # queued merge dropped by the overload watermark
    "shed-fault",  # arrival dropped: the cohort's survivors all died
    "degraded",    # watermark state flip (on=True/False)
    "fail",        # edge outage opened mid-flight; cycle voided
    "repair",      # edge back up; the voided cycle re-departed
    "failover",    # segment-boundary orphan re-association (delay side)
    "ckpt",        # durable checkpoint written (+ GC count)
    "resume",      # state restored from a checkpoint
})

#: Outage windows are wall-clock, so the open-ended service materializes
#: them ONCE at construction over this many deterministic cycle slots —
#: pure in ``fault_seed``, hence identical across crash-resumes.  Runs
#: that outlive the horizon simply see no further outages (dropout/loss
#: draws are chunked and never run out).
SERVICE_OUTAGE_HORIZON = 4096
_OUTAGE_SALT = 0x0FA17     # folds the outage draw off the cycle chunks


@dataclasses.dataclass(frozen=True)
class Segment:
    """One epoch of live traffic: a named scenario at a load multiplier.

    ``scenario`` keys ``stochastic.SCENARIOS`` (its delay model prices
    the cycle draws; a scenario's fault process is not replayed by the
    service — use the batch simulator for fault studies).  ``load``
    divides every cycle time drawn inside the segment, so ``load=4.0``
    is a 4x arrival burst.  ``duration`` is simulated seconds; the last
    segment may be ``inf`` (the service runs until its update budget).
    """
    scenario: str
    load: float = 1.0
    duration: float = math.inf


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Control-plane knobs.  Frozen so the checkpoint config echo is a
    faithful identity check on resume."""
    segments: Tuple[Segment, ...] = (Segment("deterministic"),)
    max_staleness: int = 4           # steady-state SSP gate (>= 1)
    staleness_decay: float = 0.9
    delay_seed: int = 0              # keys the per-segment draw streams
    merge_cost: Optional[float] = None   # None: 0.5 * mean cycle / M
    shed: bool = True
    backlog_high: int = 8            # enter degraded mode above this
    backlog_low: int = 2             # recover at/below this
    degraded_staleness: int = 1      # tightened gate while degraded
    ue_shed_frac: float = 0.25       # per-cohort UE shed while degraded
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0              # checkpoint cadence in events; 0=off
    keep_last_k: int = 0             # checkpoint GC: keep newest k; 0=all
    window: int = 64                 # rolling SLO window (latencies)
    sampler: str = ""                # ""=full participation; else a
                                     # repro_torch.fl.sampling name
    participation_rate: float = 1.0  # per-edge cohort fraction (0, 1]
    sample_seed: int = 0             # keys the per-cycle cohort draws
    fault_model: Optional[object] = None    # faults.FaultModel; None=clean
    fault_policy: Optional[object] = None   # faults.FaultPolicy; None with
                                            # a fault_model resolves to
                                            # deadline_failover_policy()
    fault_seed: int = 0              # keys every fault draw (windows incl.)
    merge_stream_chunk: int = 0      # >0: stream merge rows through a
                                     # chunked accumulator; 0=direct row

    def __post_init__(self):
        if self.fault_model is not None:
            if not isinstance(self.fault_model, faults_lib.FaultModel):
                raise ValueError(f"fault_model must be a "
                                 f"repro_torch.core.faults.FaultModel, got "
                                 f"{type(self.fault_model).__name__}")
            if self.max_staleness < 1:
                raise ValueError(
                    f"fault_model requires max_staleness >= 1 (outage "
                    f"failover relaxes the SSP staleness floor and the "
                    f"barrier has none — mirroring simulate_async's "
                    f"check), got max_staleness={self.max_staleness}")
            if self.fault_policy is None:
                object.__setattr__(self, "fault_policy",
                                   faults_lib.deadline_failover_policy())
        if self.fault_policy is not None and not isinstance(
                self.fault_policy, faults_lib.FaultPolicy):
            raise ValueError(f"fault_policy must be a "
                             f"repro_torch.core.faults.FaultPolicy, got "
                             f"{type(self.fault_policy).__name__}")
        if self.keep_last_k < 0:
            raise ValueError(f"keep_last_k must be >= 0 (0 keeps every "
                             f"checkpoint generation), got "
                             f"{self.keep_last_k}")
        if self.merge_stream_chunk < 0:
            raise ValueError(f"merge_stream_chunk must be >= 0 (0 uses "
                             f"the direct edge-row path), got "
                             f"{self.merge_stream_chunk}")
        if self.max_staleness < 1:
            raise ValueError("the service needs max_staleness >= 1 (the "
                             "barrier cannot be tightened or relaxed live)")
        if not (1 <= self.degraded_staleness <= self.max_staleness):
            raise ValueError("need 1 <= degraded_staleness <= max_staleness")
        if self.backlog_low >= self.backlog_high:
            raise ValueError("need backlog_low < backlog_high")
        if not (0.0 <= self.ue_shed_frac < 1.0):
            raise ValueError("need 0 <= ue_shed_frac < 1")
        if not self.segments:
            raise ValueError("need at least one traffic segment")
        for s in self.segments[:-1]:
            if not (math.isfinite(s.duration) and s.duration > 0):
                raise ValueError(f"non-final segment duration must be "
                                 f"finite and positive, got {s.duration}")
        for s in self.segments:
            stochastic.scenario(s.scenario)      # raises on unknown names
            if not (s.load > 0 and math.isfinite(s.load)):
                raise ValueError(f"segment load must be finite and "
                                 f"positive, got {s.load}")
        if not (0.0 < self.participation_rate <= 1.0):
            raise ValueError(f"participation_rate must be in (0, 1], got "
                             f"{self.participation_rate}")
        if self.sampler:
            from repro_torch.fl import sampling as fl_sampling
            fl_sampling.make_sampler(self.sampler, self.participation_rate)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["segments"] = [list(dataclasses.astuple(s)) for s in self.segments]
        if self.fault_model is not None:
            # Tag each fault process with its class: asdict alone would
            # collapse e.g. BernoulliDropout/MarkovChurn into ambiguous
            # field dicts and weaken the resume config-echo check.
            d["fault_model"] = {
                slot: (None if p is None
                       else dict(kind=type(p).__name__,
                                 **dataclasses.asdict(p)))
                for slot, p in (("dropout", self.fault_model.dropout),
                                ("loss", self.fault_model.loss),
                                ("outage", self.fault_model.outage))}
        return json.dumps(d, sort_keys=True)


@dataclasses.dataclass
class _Job:
    """A queued cloud merge: edge ``edge``'s cycle ``cycle`` arrived at
    ``t_arr`` (departed ``t_dep``) with engine staleness ``stale``;
    ``applied_at_arr`` counts merges already published when it arrived
    (queue lag adds to the effective staleness).  ``row`` is the edge's
    eq. 6 mean (F_hot,) f32; ``mass`` its aggregation weight."""
    t_arr: float
    t_dep: float
    edge: int
    cycle: int
    stale: int
    applied_at_arr: int
    mass: float
    row: np.ndarray


class HFLService:
    """Always-on control plane over an async ``HFLSimulator``.

    ``sim`` must be ``mode="async"`` with ``schedule.problem`` set (the
    delay draws need the eq. 1-5/8 ingredients) and
    ``max_staleness == config.max_staleness``, on one device or a mesh of
    ranks (every rank runs the service in step).  The service owns the
    published cloud vector ``g`` (host float32); the simulator's flat
    buffer, on its device, carries the per-UE replicas it trains on
    departures.
    """

    def __init__(self, sim, config: ServiceConfig):
        if sim.mode != "async":
            raise ValueError("HFLService needs an HFLSimulator built with "
                             "mode='async'")
        if sim.schedule.problem is None:
            raise ValueError("HFLService needs schedule.problem to draw "
                             "cycle times (eqs. 1-5, 8)")
        if sim.max_staleness != config.max_staleness:
            raise ValueError(
                f"simulator max_staleness={sim.max_staleness} != config "
                f"max_staleness={config.max_staleness}; build them to agree")
        self.sim = sim
        self.config = config
        sched = sim.schedule
        assoc = np.asarray(sched.assoc)
        self.active = np.flatnonzero(assoc.sum(0) > 0)
        self.M_act = int(self.active.size)
        # host copies of the hot rows' weights (float32) and edge ids
        self._w = np.asarray(sim._hot_weights)
        self._gids = np.asarray(sim._hot_gids)
        # a mesh's pad rows (weight 0) belong to no cohort
        self._real = self._w > 0
        self.w_total = float(self._w.astype(np.float64).sum())

        # Per-segment replay-stable draw streams: segment i samples under
        # fold_in(delay_seed, i), chunked so resume never re-draws the
        # consumed prefix (stochastic.CycleTimeSource).
        base = self._delay_key()
        self._sources = [
            stochastic.CycleTimeSource(
                stochastic.scenario(s.scenario).model,
                base.fold_in(i), sched.problem, assoc,
                sched.a, sched.b)
            for i, s in enumerate(config.segments)]
        self._seg_ends = list(np.cumsum(
            [s.duration for s in config.segments]))

        # -- live fault layer -----------------------------------------------
        # Everything here is PURE in (config, fault_seed): windows, the
        # per-segment fault sources and the boundary failover associations
        # are re-derived identically at resume, so none of it is
        # checkpointed.
        fm = config.fault_model
        self._fault_on = fm is not None and not fm.is_null()
        self._fsrc: List = []
        self._fsrc_fo: List = []
        self._fo_active: List = []
        self._fo_info: List[Optional[dict]] = [None] * len(config.segments)
        self._windows_full: List[Tuple[int, float, float]] = []
        eng_outages = None
        eng_failover = False
        if self._fault_on:
            pol = config.fault_policy
            fkey = self._fault_key()
            outage = fm.outage or faults_lib.EdgeOutage(0.0)
            self._windows_full = outage.sample_windows(
                fkey.fold_in(_OUTAGE_SALT), sched.problem,
                assoc, sched.a, sched.b, SERVICE_OUTAGE_HORIZON)
            pos_of = {int(m): i for i, m in enumerate(self.active)}
            eng_outages = [(pos_of[m], f, r)
                           for m, f, r in self._windows_full if m in pos_of]
            eng_failover = bool(pol.failover)
            # Segment-boundary failover: a segment that OPENS while edges
            # are inside an outage window re-homes their orphaned UEs onto
            # the survivors (assoc.failover) for DELAY pricing — the
            # model-side cohorts stay the planned association (the dead
            # edge's merges are voided/suppressed while it is down).
            seg_starts = [0.0] + [float(t) for t in self._seg_ends[:-1]]
            for i, (t0, s) in enumerate(zip(seg_starts, config.segments)):
                downs = sorted({int(m) for m, f, r in self._windows_full
                                if f <= t0 < r})
                model = stochastic.scenario(s.scenario).model
                ki = fkey.fold_in(i)
                self._fsrc.append(faults_lib.FaultCycleSource(
                    fm, pol, ki, sched.problem, assoc, sched.a, sched.b,
                    delay_model=model))
                if downs and pol.failover and len(downs) < self.M_act:
                    A_i = assoc_lib.failover(sched.problem, assoc, downs,
                                             a=sched.a)
                    orphans = assoc_lib.orphans_of(assoc, downs)
                    self._fo_info[i] = dict(t=t0, edges=downs,
                                            orphans=int(orphans.size))
                    self._fsrc_fo.append(faults_lib.FaultCycleSource(
                        fm, pol, ki, sched.problem, A_i, sched.a,
                        sched.b, delay_model=model))
                    self._fo_active.append(np.asarray(A_i).sum(0) > 0)
                else:
                    self._fsrc_fo.append(None)
                    self._fo_active.append(None)

        if config.merge_cost is not None:
            self.merge_cost = float(config.merge_cost)
        else:
            det = delay_lib.edge_cycle_time(sched.problem, assoc,
                                            sched.a, sched.b)[self.active]
            self.merge_cost = 0.5 * float(np.mean(det)) / self.M_act

        self.engine = events.AsyncEngine(
            self.M_act, self._cost, quota=None,
            max_staleness=config.max_staleness,
            outages=eng_outages, failover=eng_failover)

        # -- mutable control-plane state (everything a checkpoint holds) --
        self.g = sim.cloud_vector().cpu().numpy().astype(np.float32)
        self.queue: List[_Job] = []
        self.busy_until = 0.0
        self.clock = 0.0                 # last processed event time
        self.events_done = 0             # engine update events processed
        self.applied = 0                 # merges published into g
        self.shed_jobs = 0               # queued merges dropped
        self.degraded = False
        self._dep_t: Dict[Tuple[int, int], float] = {}
        self.latencies: List[float] = []
        self.backlog_seen: List[int] = []
        self.trace: List[dict] = []
        self.ckpt_wall = 0.0             # seconds spent checkpointing
        self.run_wall = 0.0              # seconds spent in run()
        self._ckpt_count = 0
        self.fault_shed = 0              # arrivals dropped: cohort all-dead
        self._dead: Dict[Tuple[int, int], bool] = {}
        self._seg_announced = 0          # last segment failover-logged
        self._fsurv_cache: Dict[Tuple[int, int], np.ndarray] = {}
        self._stream_acc = None
        if config.merge_stream_chunk > 0:
            from repro_torch.fl import aggregate as aggregate_lib
            # on the simulator's device: the cohort's rows never leave it
            self._stream_acc = aggregate_lib.StreamingEdgeAccumulator(
                1, int(self.g.shape[0]), device=sim.device)

        # Per-cycle client sampling (repro_torch.fl.sampling): a keyed
        # cohort mask per cycle, pure in (sample_seed, cycle) — resume
        # re-derives identical cohorts, so nothing extra goes into
        # checkpoints.
        if config.sampler and config.participation_rate < 1.0:
            from repro_torch.fl import sampling as fl_sampling
            self._sampler = fl_sampling.make_sampler(
                config.sampler, config.participation_rate)
        else:
            self._sampler = None
        self._part_masks: Dict[int, np.ndarray] = {}
        self._part_ipw: Dict[int, np.ndarray] = {}

        # Replay the engine's initial departures (every edge departs
        # cycle 1 at t=0) so the flat buffer holds cycle-1 results.
        for d in self.engine.departures:
            self._dep_t[(int(d.edge), int(d.cycle))] = float(d.t)
        self._replay_wave([(d.edge, d.t, d.cycle)
                           for d in self.engine.departures])

    # -- keys --------------------------------------------------------------

    def _delay_key(self):
        """The delay streams' key: ``delay_seed`` on the simulator's
        device (segment i draws under ``fold_in(i)``)."""
        return stochastic.Key(self.config.delay_seed, device=self.sim.device)

    def _fault_key(self):
        """The fault draws' key: ``fault_seed`` on the simulator's device
        (segment i under ``fold_in(i)``, the outage windows under
        ``fold_in(_OUTAGE_SALT)``)."""
        return stochastic.Key(self.config.fault_seed, device=self.sim.device)

    def _sample_key(self):
        """The cohort draws' key: ``sample_seed`` on the simulator's
        device (cycle c under ``fold_in(c)``)."""
        return stochastic.Key(self.config.sample_seed, device=self.sim.device)

    # -- traffic ---------------------------------------------------------

    def _seg_at(self, t: float) -> int:
        return min(bisect.bisect_right(self._seg_ends, t),
                   len(self._seg_ends) - 1)

    def _cost(self, m_eng: int, cycle: int, t: float) -> float:
        """Engine cost callable: scenario draw / load of the segment the
        departure falls in.  Pure in (m_eng, cycle, t) given the config —
        the property checkpoint/resume determinism rests on.  With a
        fault model the draw comes from the segment's FaultCycleSource
        (deadline cuts and retries already priced in); edges the
        segment's failover association left empty price from the base
        association (the engine needs a positive cycle time even while
        their merges are being voided)."""
        i = self._seg_at(t)
        if self._fault_on:
            m_full = int(self.active[m_eng])
            src = self._fsrc[i]
            fo = self._fsrc_fo[i]
            if fo is not None and self._fo_active[i][m_full]:
                src = fo
            ct = float(src.cycle_row(cycle - 1)[m_full])
        else:
            ct = float(self._sources[i].row(cycle - 1)[self.active[m_eng]])
        return ct / self.config.segments[i].load

    def _fault_survivors(self, t: float, cycle: int) -> np.ndarray:
        """Hot-row survivor mask for a cycle-``cycle`` departure at ``t``:
        the segment's keyed FaultCycleSource row mapped onto hot rows.
        Memoized and evicted like the sampling caches; pure in
        (fault_seed, segment, cycle), so resume re-derives it exactly."""
        i = self._seg_at(t)
        key = (i, int(cycle))
        got = self._fsurv_cache.get(key)
        if got is None:
            src = self._fsrc_fo[i] or self._fsrc[i]
            row = src.survivor_row(int(cycle) - 1)
            got = self.sim.hot_survivor_rows(row[None])[0]
            self._fsurv_cache[key] = got
            if len(self._fsurv_cache) > 64:
                for k in sorted(self._fsurv_cache)[:-32]:
                    del self._fsurv_cache[k]
        return got

    # -- model replay ----------------------------------------------------

    def _cohort(self, m_full: int) -> np.ndarray:
        """Edge ``m_full``'s members over the hot rows.  A mesh's pad rows
        carry edge ids (row-0 copies) but weight 0: they are in no cohort,
        so the shed, fallback and streamed-merge rules count the members
        the edge has on one device.  (The reference counts them: there a
        mesh service sheds pad rows in place of members and streams them
        as rows of weight 0.)"""
        return (self._gids == int(m_full)) & self._real

    def _shed_mask(self, cohorts: np.ndarray) -> Optional[np.ndarray]:
        """Degraded-mode UE participation mask over hot rows: within each
        departing cohort, drop the lowest-weight ``ue_shed_frac`` of the
        members (ties by row index; at least one survivor).  Mass is
        preserved downstream by ``survivor_weights``."""
        frac = self.config.ue_shed_frac
        if not self.degraded or frac <= 0.0:
            return None
        w = self._w.astype(np.float64)
        gids = self._gids
        ue_ok = np.ones(gids.shape[0], dtype=bool)
        for m in np.unique(gids[cohorts]):
            rows = np.flatnonzero(cohorts & self._cohort(m))
            k = min(int(frac * rows.size), rows.size - 1)
            if k > 0:
                order = np.lexsort((rows, w[rows]))
                ue_ok[rows[order[:k]]] = False
        return ue_ok

    def _participation_mask(self, cycle: int) -> np.ndarray:
        """Hot-row cohort mask for ``cycle`` — a pure keyed draw (memoized;
        ``fold_in(sample_key, cycle)``), so a resumed service re-derives
        the exact masks the crashed run used."""
        mask = self._part_masks.get(int(cycle))
        if mask is None:
            key = self._sample_key().fold_in(int(cycle))
            mask = self._sampler.sample_mask(
                key, self._w, self._gids, self.sim.schedule.num_edges)
            self._part_masks[int(cycle)] = mask
            if len(self._part_masks) > 64:
                # Always-on service: evict old cycles (the SSP gate bounds
                # how far behind a departure can be; re-deriving is a pure
                # draw anyway).  Keeps the cache O(1) in run length.
                for c in sorted(self._part_masks)[:-32]:
                    del self._part_masks[c]
        return mask

    def _ipw_weights(self, cycle: int) -> np.ndarray:
        """Hot-row inverse-propensity base weights for ``cycle`` — the
        Hajek correction for non-uniform samplers (for the uniform
        sampler this equals the raw hot weights).  Memoized and evicted
        exactly like ``_participation_mask``; pure in the same key."""
        w = self._part_ipw.get(int(cycle))
        if w is None:
            key = self._sample_key().fold_in(int(cycle))
            w = self._sampler.ipw_base_weights(
                key, self._w, self._gids, self.sim.schedule.num_edges)
            self._part_ipw[int(cycle)] = w
            if len(self._part_ipw) > 64:
                for c in sorted(self._part_ipw)[:-32]:
                    del self._part_ipw[c]
        return w

    def _replay_wave(self, departs: List[Tuple[int, float, int]]) -> None:
        """Train the departing cohorts from the published model: one
        ``replay_departure`` wave re-seeds their rows from ``g`` and runs
        the b-iteration edge cycle in place.  With a configured sampler,
        each cohort is cut to its cycle's sampled participants (composed
        by AND with the degraded-mode shed mask; ONE ``survivor_weights``
        renormalization downstream)."""
        if not departs:
            return
        gids = self._gids
        fault_ok = None
        if self._fault_on:
            # Faults are GROUND TRUTH: a churned-out or lossy-dropped UE
            # cannot be re-added by any downstream mask.  A cohort whose
            # fault survivors carry zero weight trains nobody this cycle;
            # its arrival is marked dead and shed at the cloud
            # (shed-fault) instead of publishing a zero row.
            w = self._w.astype(np.float64)
            fault_ok = np.ones(gids.shape[0], dtype=bool)
            live: List[Tuple[int, float, int]] = []
            for m_eng, t, cyc in departs:
                cohort = self._cohort(int(self.active[m_eng]))
                srow = self._fault_survivors(t, cyc)
                fault_ok[cohort] = srow[cohort]
                key = (int(m_eng), int(cyc))
                if float(w[cohort & fault_ok].sum()) > 0.0:
                    self._dead.pop(key, None)
                    live.append((m_eng, t, cyc))
                else:
                    self._dead[key] = True
            departs = live
            if not departs:
                return
        cohorts = np.zeros(gids.shape[0], dtype=bool)
        for m_eng, _t, _c in departs:
            cohorts |= self._cohort(int(self.active[m_eng]))
        ue_ok = self._shed_mask(cohorts)
        if fault_ok is not None:
            if ue_ok is None:
                ue_ok = fault_ok.copy()
            else:
                ue_ok &= fault_ok
                # The advisory shed can empty a cohort the faults left
                # alive; fall back to the fault survivors alone there.
                for m_eng, _t, _c in departs:
                    cohort = self._cohort(int(self.active[m_eng]))
                    if not (ue_ok & cohort).any():
                        ue_ok[cohort] = fault_ok[cohort]
        agg_w = None
        if self._sampler is not None:
            part = np.ones(gids.shape[0], dtype=bool)
            agg_w = self._w.astype(np.float64)
            for m_eng, _t, cyc in departs:
                cohort = self._cohort(int(self.active[m_eng]))
                part[cohort] = self._participation_mask(cyc)[cohort]
                agg_w[cohort] = self._ipw_weights(cyc)[cohort]
            combined = part if ue_ok is None else (ue_ok & part)
            # Shed/sampling composition can empty a cohort; an empty
            # cohort would publish a zero row at full mass.  Fall back to
            # the sampled cohort (cut to the fault survivors when there
            # is a fault layer), then to the fault survivors alone.
            for m_eng, _t, _c in departs:
                cohort = self._cohort(int(self.active[m_eng]))
                if not (combined & cohort).any():
                    fallback = part[cohort]
                    if fault_ok is not None:
                        fallback = fallback & fault_ok[cohort]
                        if not fallback.any():
                            fallback = fault_ok[cohort]
                    combined[cohort] = fallback
            ue_ok = combined
        g_dev = self.sim.place_cloud_vector(self.g)
        self.sim.replay_departure(g_dev, cohorts, ue_ok=ue_ok,
                                  agg_weights=agg_w)

    # -- cloud merge queue ----------------------------------------------

    def _apply(self, job: _Job, finish: float) -> None:
        """Publish one merge: staleness = engine lag at arrival + merges
        applied while queued; update rule mirrors
        ``aggregate.flat_staleness_merge`` with the job's mass as the
        arrived weight (the cohort rows all hold the edge mean, so the
        row IS the cohort's weighted contribution)."""
        stale = job.stale + (self.applied - job.applied_at_arr)
        lam = np.float32(job.mass *
                         self.config.staleness_decay ** stale /
                         self.w_total)
        self.g = (np.float32(1.0) - lam) * self.g + lam * job.row
        self.applied += 1
        lat = finish - job.t_dep
        self.latencies.append(lat)
        self.trace.append(dict(kind="merge", t=finish, edge=job.edge,
                               cycle=job.cycle, stale=int(stale),
                               latency=lat, backlog=len(self.queue),
                               mass=float(job.mass)))

    def _drain(self, t: float) -> None:
        """Serve the FIFO queue up to simulated time ``t``: every job
        whose ``merge_cost`` service completes by ``t`` publishes."""
        while self.queue:
            start = max(self.queue[0].t_arr, self.busy_until)
            finish = start + self.merge_cost
            if finish > t:
                break
            job = self.queue.pop(0)
            self.busy_until = finish
            self._apply(job, finish)

    def _shed_excess(self, t: float) -> None:
        """Degraded-mode backlog cut: drop the lowest-(mass, arrival,
        edge) queued jobs — never the in-service head — until the backlog
        is back at ``backlog_high``."""
        while len(self.queue) > self.config.backlog_high:
            idx = min(range(1, len(self.queue)),
                      key=lambda i: (self.queue[i].mass,
                                     self.queue[i].t_arr,
                                     self.queue[i].edge))
            job = self.queue.pop(idx)
            self.shed_jobs += 1
            self.trace.append(dict(kind="shed", t=t, edge=job.edge,
                                   cycle=job.cycle, mass=job.mass))

    def _update_watermarks(self, t: float) -> None:
        if not self.config.shed:
            return
        depth = len(self.queue)
        if depth > self.config.backlog_high:
            if not self.degraded:
                self.degraded = True
                self.engine.max_staleness = self.config.degraded_staleness
                self.trace.append(dict(kind="degraded", t=t, on=True,
                                       backlog=depth))
            self._shed_excess(t)
        elif self.degraded and depth <= self.config.backlog_low:
            self.degraded = False
            self.engine.max_staleness = self.config.max_staleness
            self.trace.append(dict(kind="degraded", t=t, on=False,
                                   backlog=depth))

    # -- event loop ------------------------------------------------------

    def _process(self, records: List[tuple]) -> None:
        """Handle one engine step's trace records in order: drain the
        queue to the event time, enqueue the arrival's merge job (payload
        captured BEFORE any re-depart overwrites the cohort rows), run
        the watermark logic, then train the step's departures as one
        wave seeded from the currently-published model."""
        departs: List[Tuple[int, float, int]] = []
        for kind, ev in records:
            if kind == "depart":
                key = (int(ev.edge), int(ev.cycle))
                # First-keep: a cycle voided by an outage re-departs at
                # repair under the SAME cycle id — its merge latency must
                # run from the ORIGINAL dispatch (window + redo priced in).
                if key not in self._dep_t:
                    self._dep_t[key] = float(ev.t)
                departs.append((int(ev.edge), float(ev.t), int(ev.cycle)))
                self.clock = max(self.clock, float(ev.t))
            elif kind == "fail":
                self.trace.append(dict(
                    kind="fail", t=float(ev.t),
                    edge=int(self.active[int(ev.edge)]),
                    cycle=int(ev.cycle)))
                self.clock = max(self.clock, float(ev.t))
            elif kind == "repair":
                self.trace.append(dict(
                    kind="repair", t=float(ev.t),
                    edge=int(self.active[int(ev.edge)])))
            elif kind == "update":
                t = float(ev.t)
                self._drain(t)
                for m_eng, c, s in ev.merges:
                    m_full = int(self.active[m_eng])
                    dkey = (int(m_eng), int(c))
                    if self._dead.pop(dkey, False):
                        # The whole cohort was fault-dead at departure:
                        # the arrival carries zero survivor mass, so it
                        # is dropped at the cloud instead of published.
                        self._dep_t.pop(dkey, None)
                        self.fault_shed += 1
                        self.trace.append(dict(
                            kind="shed-fault", t=t, edge=m_full,
                            cycle=int(c)))
                        continue
                    self.queue.append(_Job(
                        t_arr=t,
                        t_dep=self._dep_t.pop(dkey),
                        edge=m_full, cycle=int(c), stale=int(s),
                        applied_at_arr=self.applied,
                        mass=self.sim.edge_mass(m_full),
                        row=self._merge_row(m_full)))
                self.backlog_seen.append(len(self.queue))
                self._update_watermarks(t)
                self.clock = max(self.clock, t)
                self.events_done += 1
        self._announce_segments()
        if departs:
            self._drain(max(t for _, t, _ in departs))
            self._replay_wave(departs)

    def _merge_row(self, m_full: int) -> np.ndarray:
        """The merge payload: edge ``m_full``'s weighted cohort mean (one
        broadcast row).  With ``merge_stream_chunk > 0`` the cohort's
        rows fold through the persistent streaming accumulator chunk by
        chunk instead — O(chunk * F) resident regardless of cohort size,
        bitwise-stable across resumes, parity <= 1e-5 with the direct
        read.  The chunks stay on the simulator's device (``device_rows``;
        one ``segment_sum`` launch each on the card); only the mean comes
        back to the host."""
        chunk = self.config.merge_stream_chunk
        if chunk <= 0:
            return self.sim.edge_mean_row(m_full).cpu().numpy().astype(
                np.float32)
        w = self._w.astype(np.float64)
        idx = np.flatnonzero(self._cohort(m_full))
        acc = self._stream_acc.reset()
        for s in range(0, idx.size, chunk):
            sel = idx[s:s + chunk]
            acc.add(self.sim.device_rows(sel), w[sel],
                    np.zeros(sel.size, np.int32))
        return acc.edge_means()[0].cpu().numpy().astype(np.float32)

    def _announce_segments(self) -> None:
        """Emit one ``failover`` trace record the first time the clock
        enters a segment whose boundary re-homed orphans (idempotent
        across resumes: the watermark is checkpointed)."""
        if not self._fault_on:
            return
        seg_now = self._seg_at(self.clock)
        while self._seg_announced < seg_now:
            self._seg_announced += 1
            info = self._fo_info[self._seg_announced]
            if info is not None:
                self.trace.append(dict(
                    kind="failover", t=float(info["t"]),
                    seg=self._seg_announced, edges=list(info["edges"]),
                    orphans=int(info["orphans"])))

    def run(self, max_updates: int, verbose: bool = False) -> dict:
        """Process engine events until ``events_done`` reaches
        ``max_updates`` (cumulative across resumes), checkpointing every
        ``ckpt_every`` events.  Returns ``summary()``."""
        cfg = self.config
        wall0 = time.perf_counter()
        try:
            while self.events_done < max_updates:
                self._process(self.engine.step())
                if (cfg.ckpt_every and cfg.ckpt_dir and
                        self.events_done % cfg.ckpt_every == 0):
                    self.checkpoint()
                if verbose and self.events_done % 50 == 0:
                    s = self.summary()
                    print(f"[service] ev={self.events_done:5d} "
                          f"t={self.clock:9.2f}s p95={s['p95']:.3f}s "
                          f"backlog={len(self.queue)} "
                          f"shed={self.shed_jobs}")
        finally:
            self.run_wall += time.perf_counter() - wall0
        # The backlog is deliberately NOT drained here: the service is
        # always-on, and a checkpoint taken now must describe the same
        # mid-flight state an uninterrupted run carries past this event
        # (crash-resume parity).  Call ``drain()`` at real shutdown.
        if (cfg.ckpt_every and cfg.ckpt_dir and
                self.events_done % cfg.ckpt_every != 0):
            self.checkpoint()        # final state (cadence didn't just)
        return self.summary()

    def drain(self) -> dict:
        """Terminal shutdown: publish the whole remaining backlog at its
        natural service-completion times and return ``summary()``."""
        self._drain(math.inf)
        return self.summary()

    # -- SLO metrics -----------------------------------------------------

    def summary(self) -> dict:
        lat = np.asarray(self.latencies, np.float64)
        roll = lat[-self.config.window:]
        total = self.applied + self.shed_jobs
        return dict(
            events=self.events_done, applied=self.applied,
            shed=self.shed_jobs, fault_shed=self.fault_shed,
            shed_frac=self.shed_jobs / total if total else 0.0,
            makespan=self.clock,
            p50=float(np.percentile(lat, 50)) if lat.size else 0.0,
            p95=float(np.percentile(lat, 95)) if lat.size else 0.0,
            rolling_p50=float(np.percentile(roll, 50)) if roll.size else 0.0,
            rolling_p95=float(np.percentile(roll, 95)) if roll.size else 0.0,
            backlog_peak=int(max(self.backlog_seen, default=0)),
            merge_cost=self.merge_cost,
            run_wall=self.run_wall, ckpt_wall=self.ckpt_wall,
            ckpt_overhead_frac=(self.ckpt_wall / self.run_wall
                                if self.run_wall > 0 else 0.0),
            updates_per_wall_sec=(self.events_done / self.run_wall
                                  if self.run_wall > 0 else 0.0),
        )

    def global_params(self):
        """The published cloud model as a parameter pytree."""
        return self.sim.global_from_vector(self.g)

    def to_jsonl(self, path: str) -> str:
        """Versioned JSONL export of the service trace (header + one
        record per line; see ``load_service_trace_jsonl``).  On a mesh,
        rank 0 writes it."""
        def write():
            with open(path, "w", encoding="utf-8") as f:
                f.write(json.dumps({
                    "schema": SERVICE_TRACE_SCHEMA,
                    "version": SERVICE_TRACE_VERSION,
                    "num_records": len(self.trace),
                    "summary": self.summary(),
                }) + "\n")
                for rec in self.trace:
                    f.write(json.dumps(rec) + "\n")
            return path

        return self._on_rank0(write)

    # -- durability ------------------------------------------------------

    def _state_tree(self) -> dict:
        q = self.queue
        F = self.g.shape[0]
        return {
            "flat": self.sim.flat_state(),
            "g": self.g.copy(),
            "engine": self.engine.snapshot(),
            "queue": {
                "t_arr": np.asarray([j.t_arr for j in q], np.float64),
                "t_dep": np.asarray([j.t_dep for j in q], np.float64),
                "edge": np.asarray([j.edge for j in q], np.int64),
                "cycle": np.asarray([j.cycle for j in q], np.int64),
                "stale": np.asarray([j.stale for j in q], np.int64),
                "applied_at_arr": np.asarray(
                    [j.applied_at_arr for j in q], np.int64),
                "mass": np.asarray([j.mass for j in q], np.float64),
                "rows": (np.stack([j.row for j in q])
                         if q else np.zeros((0, F), np.float32)),
            },
            "dep": {
                "edge": np.asarray([e for e, _ in self._dep_t],
                                   np.int64),
                "cycle": np.asarray([c for _, c in self._dep_t],
                                    np.int64),
                "t": np.asarray(list(self._dep_t.values()), np.float64),
            },
            "dead": {
                "edge": np.asarray([e for e, _ in self._dead],
                                   np.int64),
                "cycle": np.asarray([c for _, c in self._dead],
                                    np.int64),
            },
            "svc": {
                "busy_until": np.float64(self.busy_until),
                "clock": np.float64(self.clock),
                "events_done": np.int64(self.events_done),
                "applied": np.int64(self.applied),
                "shed_jobs": np.int64(self.shed_jobs),
                "fault_shed": np.int64(self.fault_shed),
                "seg_announced": np.int64(self._seg_announced),
                "degraded": np.int64(self.degraded),
                "ckpt_count": np.int64(self._ckpt_count),
            },
            "metrics": {
                "latencies": np.asarray(self.latencies, np.float64),
                "backlog_seen": np.asarray(self.backlog_seen, np.int64),
            },
            "trace_json": np.str_(json.dumps(self.trace)),
        }

    def checkpoint(self) -> str:
        """Atomically persist the full control-plane state as
        ``ckpt-<n>.npz`` under ``config.ckpt_dir`` (on a mesh: every rank
        gathers the state, rank 0 writes it, the others wait for it)."""
        if not self.config.ckpt_dir:
            raise ValueError("config.ckpt_dir is unset")
        t0 = time.perf_counter()
        self._ckpt_count += 1
        path = f"{self.config.ckpt_dir}/ckpt-{self._ckpt_count}.npz"
        tree = self._state_tree()

        def write():
            save_pytree(path, tree, metadata={
                "schema": SERVICE_CKPT_VERSION,
                "config": self.config.to_json(),
            })
            if self.config.keep_last_k > 0:
                return len(gc_checkpoints(self.config.ckpt_dir,
                                          self.config.keep_last_k))
            return 0

        gc_n = self._on_rank0(write)
        dt = time.perf_counter() - t0
        self.ckpt_wall += dt
        self.trace.append(dict(kind="ckpt", t=self.clock,
                               n=self._ckpt_count, wall=dt, gc=gc_n))
        return path

    def _on_rank0(self, fn):
        """``fn()`` on one device, or on rank 0 of the simulator's mesh
        while the other ranks wait for its result (one broadcast)."""
        mesh = self.sim.mesh
        if mesh is None:
            return fn()
        out = [fn() if mesh.rank == 0 else None]
        dist.broadcast_object_list(out, src=0)
        return out[0]

    def _restore_tree(self, tree: dict, meta: dict) -> None:
        schema = int(np.asarray(meta["schema"]))
        if schema != SERVICE_CKPT_VERSION:
            raise CheckpointError(
                f"service checkpoint schema {schema} != supported "
                f"{SERVICE_CKPT_VERSION}")
        echo = str(np.asarray(meta["config"]))
        if echo != self.config.to_json():
            raise CheckpointError(
                "checkpoint was taken under a different service config; "
                "resume with the exact config it was written with.\n"
                f"  checkpoint: {echo}\n  this run:   "
                f"{self.config.to_json()}")
        self.sim.set_flat_state(np.asarray(tree["flat"], np.float32))
        self.g = np.asarray(tree["g"], np.float32).copy()
        self.engine.restore(tree["engine"])
        q = tree["queue"]
        rows = np.asarray(q["rows"], np.float32)
        self.queue = [
            _Job(t_arr=float(q["t_arr"][i]), t_dep=float(q["t_dep"][i]),
                 edge=int(q["edge"][i]), cycle=int(q["cycle"][i]),
                 stale=int(q["stale"][i]),
                 applied_at_arr=int(q["applied_at_arr"][i]),
                 mass=float(q["mass"][i]), row=rows[i].copy())
            for i in range(int(np.asarray(q["edge"]).size))]
        d = tree["dep"]
        self._dep_t = {
            (int(e), int(c)): float(t)
            for e, c, t in zip(np.asarray(d["edge"]),
                               np.asarray(d["cycle"]),
                               np.asarray(d["t"]))}
        dd = tree["dead"]
        self._dead = {
            (int(e), int(c)): True
            for e, c in zip(np.asarray(dd["edge"]),
                            np.asarray(dd["cycle"]))}
        svc = tree["svc"]
        self.busy_until = float(np.asarray(svc["busy_until"]))
        self.clock = float(np.asarray(svc["clock"]))
        self.events_done = int(np.asarray(svc["events_done"]))
        self.applied = int(np.asarray(svc["applied"]))
        self.shed_jobs = int(np.asarray(svc["shed_jobs"]))
        self.fault_shed = int(np.asarray(svc["fault_shed"]))
        self._seg_announced = int(np.asarray(svc["seg_announced"]))
        self.degraded = bool(int(np.asarray(svc["degraded"])))
        self._ckpt_count = int(np.asarray(svc["ckpt_count"]))
        m = tree["metrics"]
        self.latencies = list(np.asarray(m["latencies"], np.float64))
        self.backlog_seen = [int(x) for x in np.asarray(m["backlog_seen"])]
        self.trace = json.loads(str(np.asarray(tree["trace_json"])))

    def restore_latest(self) -> Optional[str]:
        """Resume from the newest VALID checkpoint in ``config.ckpt_dir``.

        Falls back through older checkpoints when the newest is
        corrupted (``CheckpointError``); returns the path restored from,
        or ``None`` when the directory holds no checkpoints (a fresh
        start).  Raises if every candidate is damaged."""
        if not self.config.ckpt_dir:
            raise ValueError("config.ckpt_dir is unset")
        paths = list_checkpoints(self.config.ckpt_dir)
        if not paths:
            return None
        last_err: Optional[Exception] = None
        for path in reversed(paths):
            try:
                tree, meta = load_pytree(path)
            except CheckpointError as e:
                last_err = e        # damaged file: fall back a generation
                continue
            # A schema/config mismatch applies to EVERY checkpoint in the
            # directory — raise it rather than silently falling back.
            self._restore_tree(tree, meta)
            self.trace.append(dict(kind="resume", t=self.clock,
                                   path=path))
            return path
        raise CheckpointError(
            f"no readable checkpoint among {len(paths)} candidates in "
            f"{self.config.ckpt_dir}") from last_err


def load_service_trace_jsonl(path: str) -> Tuple[dict, List[dict]]:
    """Load + validate a service trace export (mirrors
    ``events.load_trace_jsonl`` for the service's schema)."""
    with open(path, encoding="utf-8") as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"{path}: empty trace file (no header line)")
    header = json.loads(lines[0])
    if header.get("schema") != SERVICE_TRACE_SCHEMA:
        raise ValueError(f"{path}: not an {SERVICE_TRACE_SCHEMA} export "
                         f"(schema={header.get('schema')!r})")
    if header.get("version") != SERVICE_TRACE_VERSION:
        raise ValueError(f"{path}: unknown service trace version "
                         f"{header.get('version')!r}; this build reads "
                         f"version {SERVICE_TRACE_VERSION} only")
    records = [json.loads(ln) for ln in lines[1:]]
    if len(records) != header.get("num_records"):
        raise ValueError(f"{path}: truncated trace — header promises "
                         f"{header.get('num_records')} records, file "
                         f"holds {len(records)}")
    for i, rec in enumerate(records):
        kind = rec.get("kind")
        if kind not in SERVICE_TRACE_KINDS:
            raise ValueError(
                f"{path}: record {i} has unknown kind {kind!r}; "
                f"version {SERVICE_TRACE_VERSION} records are one of "
                f"{sorted(SERVICE_TRACE_KINDS)}")
    return header, records


def default_service_sim(num_ues: int = 24, num_edges: int = 4, *,
                        max_staleness: int = 4,
                        staleness_decay: float = 0.9, seed: int = 0,
                        device=None):
    """The standard service workload: the paper's planned schedule over
    a synthetic logreg federation (the ``bench_faults`` setup), wrapped
    in an async ``HFLSimulator`` on ``device`` (``None``: the card) ready
    for :class:`HFLService`."""
    from repro_torch.core import schedule as schedule_lib
    from repro_torch.core.problem import HFLProblem
    from repro_torch.data import partition, synthetic
    from repro_torch.fl.sim import HFLSimulator
    from repro_torch.models import lenet

    prob = HFLProblem(num_edges=num_edges, num_ues=num_ues, seed=seed)
    sch = schedule_lib.plan(prob)
    n_train = int(prob.samples.sum())
    train = synthetic.logreg_data(seed=seed, n=n_train, dim=12,
                                  num_classes=4)
    rng = np.random.default_rng(seed)
    parts = partition.size_partition(rng, n_train,
                                     prob.samples.astype(int))
    ue_data = [{k: train[k][ix] for k in train} for ix in parts]
    init = lenet.logreg_init(12, 4, device=device)

    def loss_fn(p, b):
        return lenet.logreg_loss(p, b, l2=1e-3)

    return HFLSimulator(sch, loss_fn, init, ue_data, mode="async",
                        max_staleness=max_staleness,
                        staleness_decay=staleness_decay, seed=seed,
                        device=device)


def _parse_segments(spec: str) -> Tuple[Segment, ...]:
    """``name:load:duration,...`` — duration ``inf`` allowed on the last."""
    out = []
    for part in spec.split(","):
        bits = part.strip().split(":")
        if len(bits) != 3:
            raise ValueError(f"segment {part!r} is not name:load:duration")
        out.append(Segment(bits[0], float(bits[1]), float(bits[2])))
    return tuple(out)


def main(argv=None) -> dict:
    import argparse

    ap = argparse.ArgumentParser(
        description="Always-on HFL control plane (crash-tolerant).")
    ap.add_argument("--ues", type=int, default=24)
    ap.add_argument("--edges", type=int, default=4)
    ap.add_argument("--max-staleness", type=int, default=4)
    ap.add_argument("--segments", default="deterministic:1.0:inf",
                    help="name:load:duration,... (simulated seconds)")
    ap.add_argument("--max-updates", type=int, default=200,
                    help="stop after this many cloud events (cumulative)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest valid checkpoint first")
    ap.add_argument("--no-shed", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fault-scenario", default="",
                    help="inject this registry scenario's fault model "
                         "(e.g. ue_churn, edge_outage, lossy_uplink)")
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--wait-for-all", action="store_true",
                    help="unprotected fault policy: no deadline, no "
                         "retries, no failover (the naive baseline)")
    ap.add_argument("--keep-last-k", type=int, default=0,
                    help="GC all but the newest k checkpoints after "
                         "each save (0 keeps everything)")
    ap.add_argument("--stream-chunk", type=int, default=0,
                    help="fold merge payloads through the streaming "
                         "accumulator in chunks of this many rows")
    ap.add_argument("--out", default=None, help="summary JSON path")
    ap.add_argument("--trace", default=None, help="trace JSONL path")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the simulator's model runs (cuda or cpu)")
    args = ap.parse_args(argv)

    fault_model = None
    fault_policy = None
    if args.fault_scenario:
        fault_model = stochastic.scenario(args.fault_scenario).faults
        if fault_model is None:
            raise SystemExit(
                f"scenario {args.fault_scenario!r} carries no fault "
                f"model; pick a fault scenario (ue_churn, edge_outage, "
                f"lossy_uplink)")
        if args.wait_for_all:
            fault_policy = faults_lib.wait_for_all_policy()
    cfg = ServiceConfig(segments=_parse_segments(args.segments),
                        max_staleness=args.max_staleness,
                        delay_seed=args.seed, shed=not args.no_shed,
                        ckpt_dir=args.ckpt_dir,
                        ckpt_every=args.ckpt_every if args.ckpt_dir else 0,
                        keep_last_k=args.keep_last_k,
                        fault_model=fault_model,
                        fault_policy=fault_policy,
                        fault_seed=args.fault_seed,
                        merge_stream_chunk=args.stream_chunk)
    sim = default_service_sim(args.ues, args.edges,
                              max_staleness=args.max_staleness,
                              seed=args.seed, device=args.device)
    svc = HFLService(sim, cfg)
    if args.resume:
        src = svc.restore_latest()
        print(f"[service] resumed from {src}" if src else
              "[service] no checkpoint found; fresh start")
    svc.run(args.max_updates, verbose=args.verbose)
    summary = svc.drain()       # resumable checkpoints are already on disk
    print(json.dumps(summary, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    if args.trace:
        svc.to_jsonl(args.trace)
    return summary


if __name__ == "__main__":
    main()
