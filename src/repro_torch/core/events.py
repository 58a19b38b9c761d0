"""Event-driven asynchronous edge-round timeline — BEYOND-PAPER.

The paper's delay model is fully synchronous: every edge waits for the
slowest of its UEs (tau_m, eq. 33) and the cloud waits for the slowest
edge (T, eq. 34), so one cloud round costs ``T = max_m { b tau_m + t_mc }``
and a job of R rounds costs exactly ``R * T`` no matter how heterogeneous
the fleet is.  This module relaxes the cloud barrier: each edge m runs its
full cycle ``c_m = b * tau_m + t_{m->c}`` at its OWN simulated clock and
re-enters immediately; the cloud aggregates whenever an edge's model
arrives (the FedAsync/HierFAVG regime of Liu et al. 2019 and the
delay-efficient scheduling analysis of Prakash et al. 2021).

Staleness control (SSP-style, bounded by ``max_staleness``):

* an edge that has completed ``k`` cycles may START its next cycle only if
  ``k - min_m completed_m <= max_staleness`` — fast edges run at most
  ``max_staleness`` cycles ahead of the slowest, then idle at the gate;
* each merge records the edge's VERSION LAG (number of cloud updates
  applied since the edge departed); the simulator decays the edge's
  aggregation weight by it (see ``repro.fl.sim``).  The cycle gate bounds
  the version lag by ``M * (max_staleness + 1)``.
* ``max_staleness=0`` degenerates EXACTLY to the synchronous path: no edge
  may run ahead, arrivals are held until all M edges have delivered, and
  the cloud applies one barrier merge of all edges at ``max_m`` arrival
  time — reproducing eq. 34 event-for-event.

Fairness of the sync-vs-async comparison: the engine terminates after
``rounds * M`` single-edge deliveries — the same communication work the
synchronous schedule performs in ``rounds`` cloud rounds — so the async
makespan is directly comparable to the eq. 34 bound ``rounds * T``.

Determinism: the event queue is keyed ``(time, edge, cycle)``, so tied
timestamps resolve by edge index and the trace is bit-identical across
runs; gated edges are released in edge-index order.

Stochastic delays (``repro.core.stochastic``): ``cycle_times`` may be a
``(C, M)`` matrix of PER-CYCLE draws instead of a constant ``(M,)``
vector — edge ``m``'s ``c``-th cycle then costs ``cycle_times[c-1, m]``,
i.e. each departure consumes a fresh draw.  The engine never samples
itself: callers pre-draw the whole matrix in one vectorized call (no
per-edge Python on the hot path) and the engine just indexes it, which
keeps the trace a pure function of the matrix.  ``C`` must cover every
cycle any edge can start: ``rounds + max_staleness`` rows suffice (an
edge departs cycle ``k+1`` only while ``delivered < rounds*M`` with
``k <= floor + max_staleness`` and ``floor <= rounds - 1``).

Copied from the JAX package's ``repro/core/events.py`` (numpy only).
"""
from __future__ import annotations

import dataclasses
import heapq
import json
from typing import Callable, List, Optional, Tuple

import numpy as np

#: Schema identity of the serialized trace (``AsyncTimeline.to_jsonl`` /
#: ``load_trace_jsonl``) — bump the version on any record-shape change so
#: stale exports are rejected instead of silently misread.
TRACE_SCHEMA = "hfl-async-trace"
TRACE_VERSION = 1

#: Version tag carried inside ``AsyncEngine.snapshot()`` dicts.
ENGINE_SNAPSHOT_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Departure:
    """Edge ``edge`` starts ``cycle`` (1-based) at time ``t`` carrying the
    cloud model at ``version``."""
    t: float
    edge: int
    cycle: int
    version: int


@dataclasses.dataclass(frozen=True)
class EdgeFail:
    """Edge ``edge`` fails at time ``t`` while ``cycle`` was in flight;
    that cycle is VOIDED (its delivery never reaches the cloud) and the
    edge re-departs the same cycle at the repair time."""
    t: float
    edge: int
    cycle: int


@dataclasses.dataclass(frozen=True)
class EdgeRepair:
    """Edge ``edge`` comes back at time ``t`` and re-enters the loop."""
    t: float
    edge: int


@dataclasses.dataclass(frozen=True)
class CloudUpdate:
    """Cloud aggregation event at time ``t`` producing model ``version``.

    ``merges`` is a tuple of ``(edge, cycle, staleness)`` in deterministic
    arrival order (ties by edge index); ``staleness`` is the edge's version
    lag — cloud updates applied since that edge departed.  Barrier merges
    (``max_staleness=0``) carry all M edges with staleness 0.
    """
    t: float
    version: int
    merges: Tuple[Tuple[int, int, int], ...]


@dataclasses.dataclass
class AsyncTimeline:
    """Full trace of one async run + its summary statistics.

    ``trace`` interleaves ``("depart", Departure)`` / ``("update",
    CloudUpdate)`` records in exact occurrence order — the FL simulator
    replays it verbatim (``repro.fl.sim`` mode="async").  Under injected
    outages (``simulate_async(outages=...)``) it additionally carries
    ``("fail", EdgeFail)`` / ``("repair", EdgeRepair)`` records (clock
    annotations: the voided cycle's delivery simply never appears; the
    records are appended at void-detection, timestamps carry the true
    fail/repair times).
    """
    num_edges: int
    rounds: int
    max_staleness: int
    cycle_times: np.ndarray              # (M,) constant, or (C, M) per-cycle
    departures: List[Departure]
    updates: List[CloudUpdate]
    trace: List[tuple]
    makespan: float                      # quota-filling update time - start
    start: float = 0.0
    failures: List[EdgeFail] = dataclasses.field(default_factory=list)
    repairs: List[EdgeRepair] = dataclasses.field(default_factory=list)

    # -- summary statistics -------------------------------------------------

    @property
    def update_times(self) -> np.ndarray:
        return np.asarray([u.t for u in self.updates])

    def update_gaps(self) -> np.ndarray:
        """Gaps between consecutive cloud updates (first gap measured from
        the run's ``start``)."""
        t = self.update_times
        return np.diff(np.concatenate([[self.start], t]))

    def cloud_idle_frac(self) -> float:
        """Longest stretch without cloud news, as a fraction of makespan.

        Synchronous schedules score ``T / (R*T) = 1/R`` (the cloud hears
        nothing for a full round); async merges arrive spread out, so the
        worst silent window shrinks toward ``max_m c_m / makespan / b``.
        """
        if not self.updates or self.makespan <= 0:
            return 0.0
        return float(self.update_gaps().max() / self.makespan)

    def merges_per_edge(self) -> np.ndarray:
        """(M,) deliveries each edge contributed to the quota."""
        out = np.zeros(self.num_edges, dtype=np.int64)
        for u in self.updates:
            for e, _, _ in u.merges:
                out[e] += 1
        return out

    def cycle_time_of(self, edge: int, cycle: int) -> float:
        """Cost of edge ``edge``'s ``cycle``-th (1-based) cycle — constant
        per edge, or that cycle's draw under a per-cycle matrix."""
        ct = self.cycle_times
        return float(ct[cycle - 1, edge] if ct.ndim == 2 else ct[edge])

    def edge_busy_frac(self) -> np.ndarray:
        """(M,) fraction of the makespan each edge spent computing (the
        summed cost of its merged cycles); the complement is gate idle."""
        if self.makespan <= 0:
            return np.zeros(self.num_edges)
        if self.cycle_times.ndim == 1:
            return self.merges_per_edge() * self.cycle_times / self.makespan
        busy = np.zeros(self.num_edges)
        for u in self.updates:
            for e, c, _ in u.merges:
                busy[e] += self.cycle_time_of(e, c)
        return busy / self.makespan

    def max_staleness_seen(self) -> int:
        return max((s for u in self.updates for _, _, s in u.merges),
                   default=0)

    def departure_waves(self) -> List[List[Departure]]:
        """Group departures into ARRIVAL WAVES: the runs of consecutive
        ``("depart", ...)`` records between cloud updates, in trace order.

        A wave is the unit the streaming aggregation path folds — one
        gather/accumulate pass per wave over only the departing cohorts'
        rows (``repro.fl.aggregate.StreamingEdgeAccumulator``,
        ``benchmarks/bench_scale.py``) — so no O(N·F) buffer is ever
        resident no matter how many waves the trace carries.
        """
        waves: List[List[Departure]] = []
        cur: List[Departure] = []
        for kind, ev in self.trace:
            if kind == "depart":
                cur.append(ev)
            elif kind == "update" and cur:
                waves.append(cur)
                cur = []
        if cur:
            waves.append(cur)
        return waves

    # -- serialization ------------------------------------------------------

    def to_jsonl(self, path: str) -> str:
        """Export the trace as versioned JSON lines (post-hoc inspection).

        Line 1 is a header ``{"schema": "hfl-async-trace", "version": 1,
        ...}`` with the run parameters and makespan; every following line
        is one trace record ``{"kind": "depart"|"update"|"fail"|"repair",
        ...}`` in exact occurrence order.  ``load_trace_jsonl`` validates
        the header and rejects unknown schema/version values, so a reader
        never silently misinterprets records written by a different
        build.  Returns ``path``.
        """
        with open(path, "w", encoding="utf-8") as f:
            f.write(json.dumps({
                "schema": TRACE_SCHEMA, "version": TRACE_VERSION,
                "num_edges": int(self.num_edges), "rounds": int(self.rounds),
                "max_staleness": int(self.max_staleness),
                "start": float(self.start),
                "makespan": float(self.makespan),
                "num_records": len(self.trace),
            }) + "\n")
            for kind, ev in self.trace:
                rec = {"kind": kind}
                for fld, val in dataclasses.asdict(ev).items():
                    if fld == "merges":
                        val = [[int(e), int(c), int(s)] for e, c, s in val]
                    elif isinstance(val, (np.integer, int)):
                        val = int(val)
                    else:
                        val = float(val)
                    rec[fld] = val
                f.write(json.dumps(rec) + "\n")
        return path


def load_trace_jsonl(path: str) -> Tuple[dict, List[dict]]:
    """Load + validate a trace written by ``AsyncTimeline.to_jsonl``.

    Returns ``(header, records)``.  Raises ``ValueError`` on a missing or
    foreign header, an unknown schema version, or a record-count mismatch
    (a truncated export).
    """
    with open(path, encoding="utf-8") as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"{path}: empty trace file (no header line)")
    try:
        header = json.loads(lines[0])
    except json.JSONDecodeError as e:
        raise ValueError(f"{path}: malformed trace header: {e}") from None
    if header.get("schema") != TRACE_SCHEMA:
        raise ValueError(
            f"{path}: not an {TRACE_SCHEMA} export "
            f"(schema={header.get('schema')!r})")
    if header.get("version") != TRACE_VERSION:
        raise ValueError(
            f"{path}: unknown trace schema version "
            f"{header.get('version')!r}; this build reads version "
            f"{TRACE_VERSION} only")
    records = [json.loads(ln) for ln in lines[1:]]
    if len(records) != header.get("num_records"):
        raise ValueError(
            f"{path}: truncated trace — header promises "
            f"{header.get('num_records')} records, file holds "
            f"{len(records)}")
    return header, records


class AsyncEngine:
    """Steppable twin of ``simulate_async`` — the resumable control-plane
    core (BEYOND-PAPER).

    ``simulate_async`` drives this engine to completion in one call; a
    long-running service (``repro.launch.service``) instead calls
    ``step()`` once per event boundary, interleaving model replay, SLO
    accounting and durable checkpoints between events.  The engine's
    whole dynamic state is plain numpy/python — ``snapshot()`` captures
    it losslessly (float64 clocks, int64 counters) and ``restore()``
    resumes a fresh engine to the exact event boundary, so a crash-killed
    run continues bit-identically.

    Parameters mirror ``simulate_async`` except that per-cycle costs come
    from a CALLABLE ``cost(edge, cycle, t_depart)`` (1-based cycle; the
    depart time lets a service price bursts/scenario epochs by wall
    clock).  The callable must be a pure function of its arguments for
    snapshot/restore determinism — the engine never samples.

    ``max_staleness`` is writable mid-run (>= 1 only; barrier mode is
    frozen at construction): an overloaded service TIGHTENS the gate by
    assigning a smaller value, which takes effect at the next gate
    release.  ``quota`` may be ``None`` for an open-ended run (the caller
    stops stepping when it pleases).
    """

    def __init__(self, num_edges: int, cost: Callable[[int, int, float], float],
                 *, quota: Optional[int], max_staleness: int,
                 start: float = 0.0, outages=None, failover: bool = False):
        self.M = int(num_edges)
        self._cost = cost
        self.quota = quota
        self.max_staleness = int(max_staleness)
        self._barrier = self.max_staleness == 0
        self.start = float(start)
        self.failover = bool(failover)
        self.win: List[List[Tuple[float, float]]] = [[] for _ in range(self.M)]
        for m, f, r in (outages or []):
            self.win[int(m)].append((float(f), float(r)))
        for w in self.win:
            w.sort()
        self.have_outages = any(self.win)
        if self.failover and self.have_outages and self._barrier:
            # Same contract simulate_async enforces before construction;
            # direct engine users (the always-on service) hit it here.
            raise ValueError("failover needs max_staleness >= 1 (the "
                             "barrier has no staleness floor to relax); "
                             "run the wait-for-all baseline at "
                             "max_staleness=0 instead")
        # -- dynamic state (everything snapshot() captures) -----------------
        self.heap: list = []                # (arrival_t, edge, cycle)
        self.completed = np.zeros(self.M, dtype=np.int64)
        self.dep_version = np.zeros(self.M, dtype=np.int64)
        self.dep_time = np.zeros(self.M)
        self.version = 0
        self.delivered = 0
        self.gated: set = set()
        self.pending: List[Tuple[float, int, int]] = []   # barrier mode
        # -- trace accumulators (NOT part of the snapshot) -------------------
        self.departures: List[Departure] = []
        self.updates: List[CloudUpdate] = []
        self.failures: List[EdgeFail] = []
        self.repairs: List[EdgeRepair] = []
        self.trace: List[tuple] = []
        for m in range(self.M):
            self._depart(m, 1, self.start)

    # ------------------------------------------------------------------

    @property
    def done(self) -> bool:
        return not self.heap or (self.quota is not None
                                 and self.delivered >= self.quota)

    def _down_at(self, m: int, t: float):
        """The outage window covering time ``t`` on edge ``m``, else None."""
        for f, r in self.win[m]:
            if f <= t < r:
                return (f, r)
            if f > t:
                break
        return None

    def _depart(self, m: int, cycle: int, t: float) -> None:
        if self.win[m]:                   # idle edge waits an outage out
            covering = self._down_at(m, t)
            if covering is not None:
                t = covering[1]
        ct = self._cost(m, cycle, t)
        if not (np.isfinite(ct) and ct > 0):
            raise ValueError(f"cost({m}, {cycle}, {t}) = {ct!r}; cycle "
                             f"costs must be finite and positive")
        d = Departure(t=t, edge=m, cycle=cycle, version=self.version)
        self.departures.append(d)
        self.trace.append(("depart", d))
        self.dep_version[m] = self.version
        self.dep_time[m] = t
        heapq.heappush(self.heap, (t + ct, m, cycle))

    def _voided(self, m: int, c: int, t_arr: float) -> bool:
        """If an outage opened mid-flight, void the cycle, record the
        fail/repair events and re-depart the same cycle at repair."""
        if not self.win[m]:
            return False
        for f, r in self.win[m]:
            if self.dep_time[m] < f < t_arr:
                ev_f = EdgeFail(t=f, edge=m, cycle=c)
                ev_r = EdgeRepair(t=r, edge=m)
                self.failures.append(ev_f)
                self.repairs.append(ev_r)
                self.trace.append(("fail", ev_f))
                self.trace.append(("repair", ev_r))
                self._depart(m, c, r)
                return True
            if f >= t_arr:
                break
        return False

    def step(self) -> List[tuple]:
        """Process ONE in-flight arrival (one event boundary).

        Pops the earliest pending arrival and either voids it (outage
        opened mid-flight: fail/repair/re-depart records) or applies its
        cloud update and releases any gate-eligible edges.  Returns the
        trace records appended by this step, in order — a barrier-mode
        arrival that merely joins the pending set returns ``[]``.  Calling
        ``step`` when ``done`` raises.
        """
        if self.done:
            raise RuntimeError("engine is done (quota reached or no "
                               "in-flight cycles); check .done before step()")
        n0 = len(self.trace)
        t, m, c = heapq.heappop(self.heap)
        if self._voided(m, c, t):
            return self.trace[n0:]
        if self._barrier:
            self.pending.append((t, m, c))
            if len(self.pending) < self.M:
                return self.trace[n0:]
            self.version += 1
            u = CloudUpdate(t=t, version=self.version,
                            merges=tuple((mm, cc, 0)
                                         for _, mm, cc in self.pending))
            self.updates.append(u)
            self.trace.append(("update", u))
            self.completed[:] = c
            self.delivered += self.M
            self.pending = []
            if self.quota is None or self.delivered < self.quota:
                for mm in range(self.M):
                    self._depart(mm, c + 1, t)
            return self.trace[n0:]
        self.version += 1
        u = CloudUpdate(t=t, version=self.version,
                        merges=((m, c, int(self.version - 1 -
                                           self.dep_version[m])),))
        self.updates.append(u)
        self.trace.append(("update", u))
        self.completed[m] = c
        self.delivered += 1
        if self.quota is not None and self.delivered >= self.quota:
            return self.trace[n0:]
        self.gated.add(m)
        if self.failover and self.have_outages:
            # Down edges don't drag the staleness floor: survivors keep
            # progressing through the outage (failover), instead of
            # everyone gating behind the dead edge.
            up = np.array([self._down_at(mm, t) is None
                           for mm in range(self.M)])
            floor = int(self.completed[up].min()) if up.any() \
                else int(self.completed.min())
        else:
            floor = int(self.completed.min())
        for mm in sorted(self.gated):
            if self.completed[mm] - floor <= self.max_staleness:
                self._depart(mm, int(self.completed[mm]) + 1, t)
                self.gated.discard(mm)
        return self.trace[n0:]

    # -- durable state ---------------------------------------------------

    def snapshot(self) -> dict:
        """Lossless dict of the engine's dynamic state, plain numpy only.

        Everything the next ``step()`` depends on is captured: the event
        heap (float64 arrival clocks), per-edge cycle/version/depart
        bookkeeping, the gate set, the barrier pending list and the
        CURRENT (possibly service-tightened) ``max_staleness``.  The
        trace accumulators are deliberately excluded — a service
        checkpoints its own normalized trace.  Restoring this snapshot
        into an engine built with the same configuration resumes the run
        bit-identically (the float64 clock is exact).
        """
        heap = sorted(self.heap)
        pend = self.pending
        return {
            "version_tag": np.int64(ENGINE_SNAPSHOT_VERSION),
            "heap_t": np.asarray([h[0] for h in heap], dtype=np.float64),
            "heap_edge": np.asarray([h[1] for h in heap], dtype=np.int64),
            "heap_cycle": np.asarray([h[2] for h in heap], dtype=np.int64),
            "completed": self.completed.copy(),
            "dep_version": self.dep_version.copy(),
            "dep_time": self.dep_time.copy(),
            "version": np.int64(self.version),
            "delivered": np.int64(self.delivered),
            "gated": np.asarray(sorted(self.gated), dtype=np.int64),
            "pending_t": np.asarray([p[0] for p in pend], dtype=np.float64),
            "pending_edge": np.asarray([p[1] for p in pend], dtype=np.int64),
            "pending_cycle": np.asarray([p[2] for p in pend],
                                        dtype=np.int64),
            "max_staleness": np.int64(self.max_staleness),
        }

    def restore(self, snap: dict) -> "AsyncEngine":
        """Overwrite the dynamic state with ``snap`` (from ``snapshot``).

        The engine must have been constructed with the same
        configuration (edges, cost function, outages, failover); the
        constructor's initial departures are discarded along with every
        trace accumulator — records after a restore describe the resumed
        segment only.
        """
        tag = int(np.asarray(snap["version_tag"]))
        if tag != ENGINE_SNAPSHOT_VERSION:
            raise ValueError(f"unknown engine snapshot version {tag}; this "
                             f"build reads version "
                             f"{ENGINE_SNAPSHOT_VERSION} only")
        self.heap = [(float(t), int(m), int(c)) for t, m, c in
                     zip(np.asarray(snap["heap_t"]),
                         np.asarray(snap["heap_edge"]),
                         np.asarray(snap["heap_cycle"]))]
        heapq.heapify(self.heap)
        self.completed = np.asarray(snap["completed"],
                                    dtype=np.int64).copy()
        self.dep_version = np.asarray(snap["dep_version"],
                                      dtype=np.int64).copy()
        self.dep_time = np.asarray(snap["dep_time"],
                                   dtype=np.float64).copy()
        self.version = int(np.asarray(snap["version"]))
        self.delivered = int(np.asarray(snap["delivered"]))
        self.gated = {int(m) for m in np.asarray(snap["gated"])}
        self.pending = [(float(t), int(m), int(c)) for t, m, c in
                        zip(np.asarray(snap["pending_t"]),
                            np.asarray(snap["pending_edge"]),
                            np.asarray(snap["pending_cycle"]))]
        self.max_staleness = int(np.asarray(snap["max_staleness"]))
        self.departures, self.updates = [], []
        self.failures, self.repairs, self.trace = [], [], []
        return self


def simulate_async(cycle_times, *, rounds: int, max_staleness: int,
                   start: float = 0.0, outages=None,
                   failover: bool = False) -> AsyncTimeline:
    """Run the event-driven timeline over per-edge cycle times.

    cycle_times: (M,) positive floats, one full edge cycle each
                 (``b * tau_m + t_{m->c}``, the per-edge term of eq. 34) —
                 or a (C, M) matrix of PER-CYCLE draws (row ``c-1`` is the
                 cost of every edge's ``c``-th cycle; needs
                 ``C >= rounds + max_staleness`` rows, see module doc).
    rounds:      synchronous-equivalent cloud rounds; the engine stops after
                 ``rounds * M`` deliveries (equal communication work).
    max_staleness: SSP cycle-lead bound; 0 = exact synchronous barrier.
    outages:     optional wall-clock edge-failure windows, a list of
                 ``(edge, t_fail, t_repair)`` (``repro.core.faults``
                 pre-samples them — the engine NEVER samples).  A cycle
                 in flight when its edge's window opens is VOIDED: the
                 engine emits ``("fail", EdgeFail)`` + ``("repair",
                 EdgeRepair)`` trace records and re-departs the SAME
                 cycle (same cost row) at the repair time; an idle edge
                 inside a window just waits it out.  With no windows the
                 trace is bit-identical to the window-free engine.
    failover:    with outages, exclude edges that are DOWN (inside a
                 window) from the staleness floor at gate-release time,
                 so survivors keep progressing and fill the delivery
                 quota instead of stalling behind the dead edge (the
                 naive wait-for-all behavior is ``failover=False``).
                 Requires ``max_staleness >= 1`` (the barrier has no
                 floor to relax) and, since survivors may run extra
                 cycles, more pre-sampled rows — the engine raises a
                 clear error when the matrix runs dry.
    """
    cycle_times = np.asarray(cycle_times, dtype=float)
    if cycle_times.ndim not in (1, 2):
        raise ValueError(f"cycle_times must be (M,) or (C, M), got shape "
                         f"{cycle_times.shape}")
    M = cycle_times.shape[-1]
    if M == 0:
        raise ValueError("need at least one (active) edge")
    if not np.all(np.isfinite(cycle_times)):
        bad = np.argwhere(~np.isfinite(cycle_times))[:4].tolist()
        raise ValueError(f"cycle_times must be finite; found NaN/inf at "
                         f"indices {bad} (shape {cycle_times.shape})")
    if np.any(cycle_times <= 0):
        bad = np.argwhere(cycle_times <= 0)[:4].tolist()
        raise ValueError(f"cycle times must be positive (drop inactive "
                         f"edges); found values <= 0 at indices {bad}")
    if rounds < 1 or max_staleness < 0:
        raise ValueError("rounds >= 1 and max_staleness >= 0 required")
    if cycle_times.ndim == 2 and cycle_times.shape[0] < rounds + max_staleness:
        raise ValueError(
            f"per-cycle matrix needs >= rounds + max_staleness = "
            f"{rounds + max_staleness} rows, got {cycle_times.shape[0]}")

    # Outage-window validation stays here (the engine trusts its caller,
    # already non-overlapping when windows come from
    # faults.EdgeOutage.sample_windows).
    for m, f, r in (outages or []):
        if not (0 <= int(m) < M):
            raise ValueError(f"outage edge {m} out of range for M={M}")
        if not (np.isfinite(f) and np.isfinite(r) and r > f):
            raise ValueError(f"outage window ({f}, {r}) must be finite "
                             f"with t_repair > t_fail")
    if failover and any(True for _ in (outages or [])) and max_staleness == 0:
        raise ValueError("failover needs max_staleness >= 1 (the barrier "
                         "has no staleness floor to relax); run the "
                         "wait-for-all baseline at max_staleness=0 instead")

    if cycle_times.ndim == 2:
        def cost(m: int, c: int, t: float) -> float:
            if c - 1 >= cycle_times.shape[0]:
                raise ValueError(
                    f"per-cycle matrix exhausted: edge {m} needs cycle "
                    f"{c} but only {cycle_times.shape[0]} rows were "
                    f"pre-sampled (outage failover makes survivors run "
                    f"extra cycles — provide more rows)")
            return cycle_times[c - 1, m]
    else:
        def cost(m: int, c: int, t: float) -> float:
            return cycle_times[m]

    eng = AsyncEngine(M, cost, quota=rounds * M,
                      max_staleness=max_staleness, start=start,
                      outages=outages, failover=failover)
    while not eng.done:
        eng.step()

    makespan = (eng.updates[-1].t - start) if eng.updates else 0.0
    return AsyncTimeline(num_edges=M, rounds=rounds,
                         max_staleness=max_staleness,
                         cycle_times=cycle_times,
                         departures=eng.departures, updates=eng.updates,
                         trace=eng.trace, makespan=makespan, start=start,
                         failures=eng.failures, repairs=eng.repairs)
