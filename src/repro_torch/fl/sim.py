"""Simulation backend — Algorithm 1 with a simulated wall clock, ported
from the JAX package's ``repro/fl/sim.py`` (sync and async modes, on one
device or on a mesh of ranks).

Executes the exact 3-layer schedule on stacked UE replicas while the CLOCK
advances according to the paper's delay model:

    one cloud round costs  T = max_m { b * tau_m + t_{m->c} }   (eq. 34)

so the reported time-to-accuracy curves (Figs. 4/6) reflect the wireless
delay model, not wall time.  Every UE's local data is resampled to a
common per-UE size so the replicas stack (the true D_n still drives both
the aggregation weights and the clock).

Hot-loop layout: the UE replicas live in ONE flat (N, F_total) fp32
buffer (``repro_torch.fl.flatten``) that stays on the device for the whole
run.  Local GD updates it in place through per-leaf views; each edge
(eq. 6) and cloud (eq. 10) event is one kernel launch that writes a fresh
buffer, which then replaces the old one.

Pass ``mesh=`` (a ``repro_torch.launch.mesh.AggMesh``) and the run is
data-sharded over ``torch.distributed`` ranks, as the reference's
``shard_map`` run is over devices.  Every rank builds the simulator from
the same full ``ue_data`` and calls ``run`` (and every public hook) in
step with the others; it keeps only its slab of the padded
``ShardedFlatLayout`` buffer (whole edges' UE rows, a column slab) and its
rows of the batches, weights and group ids (pad rows: row-0 copies with
weight 0, trained like any row).  Beside them it keeps host copies of the
GLOBAL padded weights and group ids (``_hot_weights``, ``_hot_gids``) and
the original-order ``weights`` and ``group_ids`` (the clock, the sampler
and its inverse-propensity weights read those).  Under a model axis a rank
all-gathers its rows' column slabs before local training and keeps its
own columns after.  Edge events need no collective; each cloud event is
one ``weighted_mean`` launch and one all-reduce over 'data', each async
merge one all-reduce over 'data'.  The public API speaks the reference's
global coordinates on every rank: ``params``, ``global_params``, the
losses, cloud vectors (``(F_hot,)``, ``F_hot`` the padded width), masks
over the ``N_hot`` padded rows and row indices into the padded buffer;
the hooks slice the rank's rows and columns inside and make their results
global with an all-reduce over 'data' and an all-gather over 'model'.

Async mode (``mode="async"``, beyond the paper): the cloud barrier of
eq. 34 is dropped.  ``repro_torch.core.events`` simulates each edge's
cycle ``b * tau_m + t_mc`` on its own clock with SSP staleness gating
(``max_staleness`` cycles of lead, 0 = the synchronous barrier), and the
run REPLAYS that event trace: a departure wave re-seeds the departing
edges' rows from the cloud model and runs their b-iteration cycle, and
each cloud update merges the arrived edges with weights decayed by
``staleness_decay ** version_lag`` (``flat_staleness_merge``).  At
``max_staleness=0`` the trajectory is the synchronous one to float
tolerance.

Stochastic clock (``delay_model=``, beyond the paper): a
``repro_torch.core.stochastic.DelayModel`` replaces the constant delays
with keyed per-cycle draws, one batched draw per run under
``Key(delay_seed)`` on the simulator's device: sync rounds cost that
round's ``max_m`` cycle draw, async departures each consume a fresh row
of the pre-sampled cycle matrix.  ``DeterministicDelays`` (and the
default ``None``) keep the constant clock exactly.

Faults and sampling (``fault_model=``, ``sampler=``, beyond the paper): a
``repro_torch.core.faults.FaultModel`` under a ``FaultPolicy`` prices the
clock with one ``faulty_cycle_stats`` draw under ``Key(fault_seed)``, and
a ``repro_torch.fl.sampling.ClientSampler`` draws every round's cohort
under ``Key(sample_seed)``, on the original rows (on a mesh too: the
masks are then padded, survivors as row-0 copies, cohorts with pad rows
never sampled).  Rounds (sync) and departure waves (async) aggregate only
the survivors or the cohort, with runtime edge weights renormalised to
keep each edge's mass (``_fault_round_weights``) and cloud weights that
zero every edge with no delivered mass; a sync round with no survivor at
all skips the cloud event.  A null fault model and a sampler at
``participation_rate=1`` are routed to ``None`` at construction, so those
runs take the legacy code byte for byte.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.func import vmap

from repro_torch import tracing
from repro_torch.core import delay, faults
from repro_torch.core.schedule import HFLSchedule
from repro_torch.core.stochastic import DeterministicDelays, Key
from repro_torch.device import resolve_device
from repro_torch.fl import aggregate, clients
from repro_torch.fl.flatten import FlatLayout, ShardedFlatLayout


@dataclasses.dataclass
class SimResult:
    times: np.ndarray          # (R,) cumulative simulated seconds per eval
    test_acc: np.ndarray       # (R,)
    test_loss: np.ndarray      # (R,)
    train_loss: np.ndarray     # (R,)
    schedule: HFLSchedule
    final_params: dict
    timeline: object = None    # core.events.AsyncTimeline (async mode only)


def _combine_masks(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """AND two (C, N) bool mask matrices with mismatched row counts by
    clamping each to its last row (the clamp the async replay applies per
    event), so faults x sampling compose into ONE mask."""
    rows = max(a.shape[0], b.shape[0])
    ai = np.minimum(np.arange(rows), a.shape[0] - 1)
    bi = np.minimum(np.arange(rows), b.shape[0] - 1)
    return a[ai] & b[bi]


class HFLSimulator:
    """Run Alg. 1 for a schedule over a federated dataset.

    loss_fn(params, batch) -> (loss, metrics) — one UE's full-batch loss.
    ``device=None`` runs on the CUDA card and raises if there is none
    (under a mesh: on the mesh's device).  ``mesh=``: this rank's
    ``AggMesh``; see the module docstring.  ``delay_model=`` (with
    ``delay_seed``) makes the clock stochastic in both modes; every rank
    of a mesh draws the same rows.  ``fault_model=`` (with
    ``fault_policy``, default ``deadline_failover_policy()``, and
    ``fault_seed``) and ``sampler=`` (with ``sample_seed``) inject faults
    and partial participation (solver ``"gd"``).
    """

    def __init__(self, schedule: HFLSchedule, loss_fn: Callable,
                 init_params: dict, ue_data: List[dict], *,
                 lr: float = 0.05, solver: str = "gd",
                 dane_mu: float = 0.1, samples_per_ue: Optional[int] = None,
                 seed: int = 0, mode: str = "sync",
                 max_staleness: Optional[int] = 0,
                 staleness_decay: float = 0.9, mesh=None, delay_model=None,
                 delay_seed: int = 0, fault_model=None, fault_policy=None,
                 fault_seed: int = 0, sampler=None, sample_seed: int = 0,
                 device=None):
        if mode not in ("sync", "async"):
            raise ValueError(f"mode must be 'sync' or 'async', got {mode!r}")
        if max_staleness is None:
            # a jointly planned schedule carries its own staleness bound
            max_staleness = int(schedule.meta.get("max_staleness", 0))
        if mode == "async" and solver != "gd":
            raise ValueError("mode='async' supports solver='gd' only (DANE's "
                             "global gradient assumes a synchronized fleet)")
        if max_staleness < 0:
            raise ValueError("max_staleness must be >= 0")
        if solver not in ("gd", "dane"):
            raise ValueError(f"solver must be 'gd' or 'dane', got {solver!r}")
        if delay_model is not None and schedule.problem is None:
            raise ValueError("delay_model= needs schedule.problem to sample "
                             "the delay ingredients (eqs. 1-5, 8)")
        if fault_model is not None and fault_model.is_null():
            fault_model = None           # the legacy paths, byte for byte
        if fault_model is not None:
            if schedule.problem is None:
                raise ValueError("fault_model= needs schedule.problem to "
                                 "price retries/deadlines (eqs. 1-5, 33)")
            if solver != "gd":
                raise ValueError("fault_model= supports solver='gd' only "
                                 "(DANE's global gradient assumes every UE "
                                 "reports; survivor masking breaks it)")
        if sampler is not None and sampler.is_full():
            sampler = None               # the legacy paths, byte for byte
        if sampler is not None and solver != "gd":
            raise ValueError("sampler= supports solver='gd' only (DANE's "
                             "global gradient assumes every UE reports; "
                             "cohort masking breaks it)")
        self.fault_model = fault_model
        self.fault_policy = (fault_policy if fault_policy is not None
                             else faults.deadline_failover_policy())
        self.fault_seed = int(fault_seed)
        self.sampler = sampler
        self.sample_seed = int(sample_seed)
        self.mesh = mesh
        self.device = resolve_device(
            mesh.device if mesh is not None and device is None else device)
        self.schedule = schedule
        self.loss_fn = loss_fn
        self.solver = solver
        self.mode = mode
        self.max_staleness = int(max_staleness)
        self.staleness_decay = float(staleness_decay)
        self.delay_model = delay_model
        self.delay_seed = int(delay_seed)
        n = schedule.num_ues
        if len(ue_data) != n:
            raise ValueError(f"{len(ue_data)} UE datasets for {n} UEs")

        # Stack UE datasets to a common size (resample with replacement);
        # the same numpy draws as the JAX package, so the batches match.
        sizes = [d["labels"].shape[0] for d in ue_data]
        k = samples_per_ue or int(np.median(sizes))
        rng = np.random.default_rng(seed)
        resample = []
        for d in ue_data:
            m = d["labels"].shape[0]
            resample.append(rng.choice(m, size=k, replace=m < k)
                            if m != k else np.arange(k))
        batches = {key: np.stack([d[key][ix] for d, ix in
                                  zip(ue_data, resample)])
                   for key in ue_data[0]}            # leaves (N, k, ...)
        # Aggregation weights: the paper's D_n (eq. 6/10).
        w = np.asarray(schedule.problem.samples if schedule.problem
                       is not None else sizes, np.float32)
        gids = schedule.assoc.argmax(1).astype(np.int32)

        stacked = _stack(init_params, n, self.device)
        self._layout = FlatLayout.of(stacked)
        if any(dt != torch.float32 for dt in self._layout.dtypes):
            # local GD writes the fp32 buffer through unravel's views, and
            # only fp32 leaves come back as views
            raise ValueError("init_params leaves must be float32, got "
                             f"{sorted(set(map(str, self._layout.dtypes)))}")
        self.weights = torch.as_tensor(w, device=self.device)
        self.group_ids = torch.as_tensor(gids, device=self.device)
        # The rows this simulator (rank) trains: all N in original order,
        # or under a mesh the rank's padded, group-aligned rows; the hot
        # (padded, global) weights and group ids stay on the host.
        if mesh is None:
            self._slayout = None
            self._rows = self._cols = slice(None)
            self._flat = self._layout.ravel(stacked)
            self._hot_weights, self._hot_gids = w, gids
            self._real_rows = np.ones(n, bool)
        else:
            sl = ShardedFlatLayout.build(self._layout, mesh, n,
                                         group_ids=gids)
            self._slayout = sl
            self._rows, self._cols = sl.local_rows, sl.local_cols
            self._flat = sl.local(sl.ravel(stacked))
            batches = {k: sl.pad_rows(v)[self._rows]
                       for k, v in batches.items()}
            self._hot_weights = sl.pad_weights(w).numpy()
            self._hot_gids = sl.pad_rows(gids)
            self._real_rows = sl.perm >= 0
        self.batches = {k: torch.as_tensor(v, device=self.device)
                        for k, v in batches.items()}
        self._local_weights = self._rows_of(self._hot_weights,
                                            torch.float32)
        self._local_gids = self._rows_of(self._hot_gids, torch.int32)
        self._local_gd = clients.gd_local_steps(loss_fn, schedule.a, lr)
        self._local_dane = clients.dane_local_steps(loss_fn, schedule.a, lr,
                                                    mu_prox=dane_mu)
        self._w_total = float(self.weights.sum())      # the fleet's W
        # Base measure of the sampled and faulty aggregations: the
        # sampler's inverse-propensity weights (static per run, drawn on
        # the original rows, then padded), else D_n.
        self._agg_weights = self._local_weights
        if sampler is not None:
            adj = sampler.ipw_base_weights(self._sample_key(), w, gids,
                                           schedule.num_edges)
            if mesh is not None:
                adj = self._slayout.pad_weights(adj)
            self._agg_weights = self._rows_of(adj, torch.float32)
        self._per_ue_loss = vmap(lambda p, bb: loss_fn(p, bb)[0],
                                 in_dims=(None, 0))

    # ------------------------------------------------------------------

    @property
    def params(self) -> dict:
        """Stacked UE replicas, unravelled from the flat buffer.  Under a
        mesh, every rank's slab is gathered (a collective: every rank must
        read it) into the global replicas in original row order."""
        if self.mesh is None:
            return self._layout.unravel(self._flat)
        return self._slayout.unravel(self._gather_full())

    @params.setter
    def params(self, stacked: dict) -> None:
        """Replace the stacked UE replicas (tensors or arrays, such as a
        checkpoint's; every UE, original row order): ravelled into a fresh
        flat buffer on this simulator's device, since local GD writes the
        buffer in place.  Under a mesh each rank keeps its slab."""
        flat = self._layout.ravel(_stack_to(stacked, self.device))
        want = (self.schedule.num_ues, self._layout.total)
        if tuple(flat.shape) != want:
            raise ValueError(f"stacked params ravel to {tuple(flat.shape)}, "
                             f"not this simulator's {want}")
        if self.mesh is not None:
            flat = self._slayout.local(self._slayout.pad(flat))
        self._flat = flat

    @property
    def _data_group(self):
        return None if self.mesh is None else self.mesh.data_group

    def _rows_of(self, x, dtype) -> torch.Tensor:
        """This rank's rows of a global per-row array or tensor (all of it
        on one device), as ``dtype`` on the simulator's device."""
        return torch.as_tensor(x, dtype=dtype, device=self.device)[self._rows]

    def _gather_cols(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` with the other model ranks' column slabs beside it (last
        axis, in model order); ``t`` itself without a model axis."""
        if self.mesh is None or self.mesh.num_model == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(self.mesh.num_model)]
        dist.all_gather(parts, t.contiguous(), group=self.mesh.model_group)
        return torch.cat(parts, -1)

    def _sum_rows(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data shards (one all-reduce over 'data'),
        then with its column slabs gathered: each rank's partial made
        global on every rank."""
        if self.mesh is not None and self.mesh.num_data > 1:
            dist.all_reduce(t, group=self.mesh.data_group)
        return self._gather_cols(t)

    def _gather_full(self) -> torch.Tensor:
        """The padded global buffer ``(n_padded, f_padded)``, assembled on
        every rank from the ranks' slabs (one all-gather)."""
        parts = [torch.empty_like(self._flat) for _ in range(self.mesh.size)]
        dist.all_gather(parts, self._flat.contiguous())
        nm = self.mesh.num_model
        return torch.cat([torch.cat(parts[i:i + nm], 1)
                          for i in range(0, len(parts), nm)], 0)

    def _delay_key(self) -> Key:
        """The run's delay key: ``delay_seed`` on this simulator's device."""
        return Key(self.delay_seed, device=self.device)

    def _fault_key(self) -> Key:
        """The run's fault key: ``fault_seed`` on this simulator's device."""
        return Key(self.fault_seed, device=self.device)

    def _sample_key(self) -> Key:
        """The run's cohort key: ``sample_seed`` on this simulator's
        device."""
        return Key(self.sample_seed, device=self.device)

    def _edge_rounds(self, flat: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
        """b edge rounds on every row of ``flat`` (the rank's rows): a local
        steps, written in place into ``flat`` through the views that
        unravel returns, then the eq. 6 edge aggregation under ``weights``
        (the rows' D_n, or a fault or sampled round's runtime weights)."""
        s = self.schedule
        for _ in range(s.b):
            rows = self._gather_cols(flat)
            p = self._layout.unravel(rows)
            with tracing.span("hfl.local_gd"):
                if self.solver == "dane":
                    g_bar = clients.global_gradient(self.loss_fn, p,
                                                    self.batches,
                                                    self._local_weights,
                                                    group=self._data_group)
                    self._local_dane(p, self.batches, g_bar)
                else:
                    self._local_gd(p, self.batches)
            if rows is not flat:          # the gathered rows are a copy
                flat.copy_(rows[:, self._cols])
            with tracing.span("hfl.aggregate"):
                flat = aggregate.flat_edge_aggregate(
                    flat, weights, self._local_gids, s.num_edges,
                    mesh=self.mesh)
        return flat

    def _cloud_round(self, w_edge=None, w_cloud=None) -> None:
        """One sync round; a fault or sampled round passes its runtime
        weights (``_fault_round_weights``)."""
        if w_edge is None:
            w_edge = w_cloud = self._local_weights
        trained = self._edge_rounds(self._flat, w_edge)
        with tracing.span("hfl.aggregate"):
            self._flat = aggregate.flat_cloud_aggregate(trained, w_cloud,
                                                        mesh=self.mesh)

    def _depart_cycle(self, g: torch.Tensor, mask: torch.Tensor,
                      w_edge: torch.Tensor) -> None:
        """Re-seed the departing rows (``mask``, the rank's rows) from the
        cloud vector ``g`` (the rank's columns), run the b-iteration edge
        cycle (Alg. 1 lines 4-9) and commit ONLY the masked rows;
        mid-flight edges' rows pass through.  As in the JAX package the
        wave trains the WHOLE buffer and drops the unmasked rows, so a wave
        costs a sync round's training.  The cycle runs on the fresh seeded
        copy, never on ``self._flat``: local GD writes in place, and the
        rows of edges in flight must not move."""
        seeded = torch.where(mask[:, None], g[None, :], self._flat)
        self._flat = torch.where(mask[:, None],
                                 self._edge_rounds(seeded, w_edge),
                                 self._flat)

    def _fault_round_weights(self, ue_ok, base=None):
        """(w_edge, w_cloud) of one round or wave from the (N_hot,) bool
        survivor or cohort mask ``ue_ok``, for this rank's rows on the
        device: edge weights renormalised to each edge's mass over the kept
        rows (``survivor_weights``: a dead cohort's weights are all 0), and
        cloud weights D_n zeroed on every edge with no kept mass.  ``base``
        (N_hot,) overrides the base measure (default: the run's, the
        sampler's inverse-propensity weights or D_n).  Every edge lives on
        one data shard, so its mass is the rank's own."""
        M = self.schedule.num_edges
        base = (self._agg_weights if base is None else
                self._rows_of(base, torch.float32))
        ok = self._rows_of(ue_ok, torch.bool)
        gids = self._local_gids.long()
        w_edge = aggregate.survivor_weights(base, ok, self._local_gids, M)
        mass = torch.zeros(M, device=self.device).index_add_(
            0, gids, base * ok.to(torch.float32))
        w_cloud = self._local_weights * (mass > 0)[gids]
        return w_edge, w_cloud

    def hot_survivor_rows(self, survivors) -> np.ndarray:
        """``(C, N)`` bool per-UE survivor masks (original UE order, such
        as ``FaultyCycles.survivors``) on the flat buffer's rows:
        ``(C, N_hot)``.  Under a mesh the rows are padded as the buffer's
        are: a pad row copies row 0's flag, and carries weight 0 wherever
        it matters."""
        surv = np.asarray(survivors, bool)
        if self._slayout is not None:
            surv = self._slayout.pad_rows(surv.T).T
        return surv

    def _participation_matrix(self, num_rounds: int) -> np.ndarray:
        """(num_rounds, N) bool cohort masks on the ORIGINAL rows, one
        batched keyed draw (``sampler.sample_rounds``); the clock reads
        them as they are."""
        return self.sampler.sample_rounds(
            self._sample_key(), self.weights.cpu().numpy(),
            self.group_ids.cpu().numpy(), self.schedule.num_edges,
            num_rounds)

    def _participation_hot(self, part: np.ndarray) -> np.ndarray:
        """(R, N) cohort masks on the flat buffer's (R, N_hot) rows, with
        ``pad_mask``: a pad row is never sampled."""
        if self._slayout is None:
            return part
        return self._slayout.pad_mask(part.T).numpy().T

    def global_params(self) -> dict:
        """The cloud model: weighted mean over UE replicas (eq. 10).  Under
        a mesh a collective (one all-reduce over 'data', one all-gather
        over 'model'): every rank must call it."""
        if self.mesh is None:
            w = self.weights / self.weights.sum()
            return self._layout.unravel_single(w @ self._flat)
        w = self._local_weights
        mean = aggregate.psum_weighted_mean(w @ self._flat, w.sum(),
                                            self._data_group)
        return self._layout.unravel_single(self._gather_cols(mean))

    def _train_loss(self, gp) -> torch.Tensor:
        """Weight-averaged train loss over ALL UEs (under a mesh, each
        rank's rows' weighted sum, then one all-reduce over 'data')."""
        losses = self._per_ue_loss(gp, self.batches)
        if self.mesh is None:
            w = self.weights / self.weights.sum()
            return (w * losses).sum()
        w = self._local_weights
        return aggregate.psum_weighted_mean(
            (w * losses).sum().reshape(1), w.sum(), self._data_group)[0]

    def _evaluate(self, gp, test: dict):
        """(test accuracy, test loss, train loss) of the global model."""
        with tracing.span("hfl.eval"), torch.no_grad():
            loss, mets = self.loss_fn(gp, test)
            trl = self._train_loss(gp)
        return float(mets.get("acc", float("nan"))), float(loss), float(trl)

    def run(self, test_batch: dict, rounds: Optional[int] = None,
            eval_every: int = 1, verbose: bool = False) -> SimResult:
        """Execute ``rounds`` cloud rounds (sync) or the equivalent async
        delivery quota (``rounds * M_active`` edge merges, mode='async';
        ``eval_every`` then counts cloud updates)."""
        if self.mode == "async":
            return self._run_async(test_batch, rounds, eval_every, verbose)
        sched = self.schedule
        rounds = rounds or sched.rounds
        round_times, kept = self._sync_plan(rounds)
        test = {k: torch.as_tensor(v, device=self.device)
                for k, v in test_batch.items()}
        times, accs, tlosses, trlosses = [], [], [], []
        clock = 0.0
        for r in range(rounds):
            with tracing.span("hfl.round"):
                if kept is None:
                    self._cloud_round()
                elif kept[r].any():
                    self._cloud_round(*self._fault_round_weights(kept[r]))
                # else: nothing delivered — the round is wasted wall-clock
                # and the model stays put (no cloud event sees all-zero
                # weights)
                clock += float(round_times[r])
                if (r + 1) % eval_every == 0 or r == rounds - 1:
                    acc, loss, trl = self._evaluate(self.global_params(),
                                                    test)
                    times.append(clock)
                    accs.append(acc)
                    tlosses.append(loss)
                    trlosses.append(trl)
                    if verbose:
                        print(f"round {r+1:3d}/{rounds}  t={clock:9.2f}s  "
                              f"acc={accs[-1]:.4f}  loss={tlosses[-1]:.4f}"
                              + ("" if kept is None else
                                 f"  kept="
                                 f"{int((kept[r] & self._real_rows).sum())}"))
        return SimResult(times=np.array(times), test_acc=np.array(accs),
                         test_loss=np.array(tlosses),
                         train_loss=np.array(trlosses),
                         schedule=sched, final_params=self.global_params())

    def _sync_plan(self, rounds: int):
        """(round_times, kept) of ``rounds`` sync rounds: each round's
        simulated seconds and its (N_hot,) bool mask of the rows it
        aggregates (``kept`` is None for the legacy rounds, which aggregate
        all).

        * Faults: one ``faulty_cycle_stats`` draw prices the run.
          Wait-for-all pays every straggler (come-back waits, unbounded
          retries, outage stalls): round r is ``max_m`` of the stalled
          cycle times.  A deadline policy cuts at ``D_m`` and skips edges
          inside an outage.  Round r keeps its survivors outside down
          edges (ANDed with the cohort under a sampler; the clock keeps
          the policy's full-fleet pricing, set before the cohort is known).
        * Sampling: round r keeps its cohort and costs eq. 34 with each
          edge's tau the member max over the cohort only
          (``participation=``; ``DeterministicDelays`` without a model).
        * Neither: the constant eq. 34 T, or one batched draw of the delay
          model (round r costs the max over edges of its cycle draw).
        """
        sched = self.schedule
        if self.fault_model is not None:
            policy = self.fault_policy
            fc = faults.faulty_cycle_stats(
                self.fault_model, policy, self._fault_key(), sched.problem,
                sched.assoc, sched.a, sched.b, rounds,
                delay_model=self.delay_model)
            if policy.name == faults.WAIT_FOR_ALL:
                round_times = (fc.cycle_times + fc.stall).max(axis=1)
            else:
                round_times = np.where(fc.down, 0.0,
                                       fc.cycle_times).max(axis=1)
            kept = self.hot_survivor_rows(fc.survivors)
            if self.sampler is not None:
                kept = kept & self._participation_hot(
                    self._participation_matrix(rounds))
            return round_times, kept & ~fc.down[:, self._hot_gids]
        if self.sampler is not None:
            kept = self._participation_matrix(rounds)
            dm = self.delay_model or DeterministicDelays()
            draws = dm.cycle_times(self._delay_key(), sched.problem,
                                   sched.assoc, sched.a, sched.b, rounds,
                                   participation=kept)
            return np.asarray(draws).max(axis=1), self._participation_hot(kept)
        if self.delay_model is not None:
            draws = self.delay_model.cycle_times(
                self._delay_key(), sched.problem, sched.assoc, sched.a,
                sched.b, rounds)
            return np.asarray(draws).max(axis=1), None
        return np.full(rounds, sched.cloud_round_time), None   # eq. (34)

    # ------------------------------------------------------------------
    # Replay hooks (mode='async'): the event-replay primitives
    # ``_run_async`` is built from, public so a driver can advance the same
    # model state one event at a time, checkpoint it and resume.  Under a
    # mesh every rank calls each hook in step with the others, with global
    # arguments, and gets the same global result.
    # ------------------------------------------------------------------

    def cloud_vector(self) -> torch.Tensor:
        """(F_hot,) fp32 cloud model: the weighted mean of the flat buffer
        (under a mesh one all-reduce over 'data' and one all-gather over
        'model')."""
        w = self._hot_weights
        coef = self._rows_of(w / w.sum(), torch.float32)
        return self._sum_rows(coef @ self._flat)

    def place_cloud_vector(self, g) -> torch.Tensor:
        """A cloud vector (array or tensor) as fp32 on the simulator's
        device."""
        if not torch.is_tensor(g):
            g = np.array(g, np.float32)       # a copy the caller cannot move
        return torch.as_tensor(g, dtype=torch.float32, device=self.device)

    def replay_departure(self, g, mask, ue_ok=None,
                         agg_weights=None) -> None:
        """One departure wave: re-seed the masked rows from ``g``, run
        their b-iteration edge cycle and commit them into the flat buffer.
        ``mask`` is an (N_hot,) bool over rows (the departing cohorts).
        With ``ue_ok`` (an (N_hot,) bool of the rows that take part: fault
        survivors, a cohort) the wave aggregates under the weights of
        ``_fault_round_weights``, over ``agg_weights`` (N_hot,) as the base
        measure if given; excluded rows still train but carry zero
        weight."""
        if self.mode != "async":
            raise RuntimeError("replay_departure requires mode='async'")
        w_edge = self._local_weights
        if ue_ok is not None:
            w_edge, _ = self._fault_round_weights(ue_ok, base=agg_weights)
        self._depart_cycle(self.place_cloud_vector(g)[self._cols],
                           self._rows_of(mask, torch.bool), w_edge)

    def replay_merge(self, g, decay) -> torch.Tensor:
        """Staleness-weighted cloud merge of the arrived edges.  ``decay``
        is (M,) float64, ``staleness_decay ** lag`` for arrived edges and
        0 elsewhere; returns the updated (F_hot,) cloud vector (under a
        mesh one all-reduce over 'data' and one all-gather over
        'model')."""
        if self.mode != "async":
            raise RuntimeError("replay_merge requires mode='async'")
        eff = (self._hot_weights * np.asarray(decay)[self._hot_gids]
               ).astype(np.float32)
        g = self.place_cloud_vector(g)[self._cols]
        return self._gather_cols(aggregate.flat_staleness_merge(
            g, self._flat, self._rows_of(eff, torch.float32), self._w_total,
            mesh=self.mesh))

    def edge_mean_row(self, m: int) -> torch.Tensor:
        """(F_hot,) fp32: edge ``m``'s model right after its cycle's eq. 6
        aggregation (every member row holds the edge mean).  The row read
        is a member's: a mesh's pad rows carry edge ids too, but on a
        shard without the edge's members their mean is 0.  (The reference
        reads the first row with the edge's id, a pad row where a padded
        shard comes before the edge's.)"""
        idx = int(np.flatnonzero((self._hot_gids == int(m))
                                 & self._real_rows)[0])
        return self.device_rows([idx])[0]

    def edge_mass(self, m: int) -> float:
        """Total aggregation weight of edge ``m``'s cohort (float64)."""
        w = self._hot_weights.astype(np.float64)
        return float(w[self._hot_gids == int(m)].sum())

    def device_rows(self, idx) -> torch.Tensor:
        """A copy of the given flat-buffer rows (indices into the N_hot
        rows) on the simulator's device: (len(idx), F_hot) fp32 (the
        service's streaming merge folds them there chunk by chunk).  Under
        a mesh each rank puts in the rows it owns, zeros elsewhere, and one
        all-reduce over 'data' and one all-gather over 'model' make the
        rows whole on every rank."""
        idx = np.asarray(idx, np.int64).reshape(-1)
        if self.mesh is None:
            return self._flat[torch.as_tensor(idx, device=self.device)]
        start, stop = self._rows.start, self._rows.stop
        mine = np.flatnonzero((idx >= start) & (idx < stop))
        out = torch.zeros((idx.size, self._flat.shape[1]),
                          dtype=self._flat.dtype, device=self.device)
        if mine.size:
            out[torch.as_tensor(mine, device=self.device)] = self._flat[
                torch.as_tensor(idx[mine] - start, device=self.device)]
        return self._sum_rows(out)

    def hot_rows(self, idx) -> np.ndarray:
        """Host copy of the given flat-buffer rows: (len(idx), F_hot)
        fp32."""
        return self.device_rows(idx).cpu().numpy()

    def global_from_vector(self, g) -> dict:
        """Unravel a cloud vector into the global parameter dict."""
        return self._layout.unravel_single(self.place_cloud_vector(g))

    def flat_state(self) -> np.ndarray:
        """Host copy of the flat buffer (checkpoint payload): under a mesh
        the padded global buffer ``(n_padded, f_padded)``, gathered on
        every rank."""
        if self.mesh is None:
            return self._flat.cpu().numpy().copy()
        return self._gather_full().cpu().numpy()

    def set_flat_state(self, flat) -> None:
        """Restore the flat buffer from a host array, such as the JAX
        package's ``HFLSimulator.flat_state()`` (under a mesh the padded
        global buffer; each rank keeps its slab)."""
        flat = np.array(flat, np.float32)    # local GD writes in place
        want = (tuple(self._flat.shape) if self.mesh is None else
                (self._slayout.n_padded, self._slayout.f_padded))
        if flat.shape != want:
            raise ValueError(f"flat buffer shape {flat.shape} does not "
                             f"match this simulator's layout {want}")
        flat = torch.as_tensor(flat, device=self.device)
        self._flat = flat if self.mesh is None else self._slayout.local(flat)

    def _run_async(self, test_batch: dict, rounds: Optional[int],
                   eval_every: int, verbose: bool) -> SimResult:
        """Replay the event-driven async timeline (see module docstring).

        The clock comes from ``core.delay.async_completion`` (per-edge
        cycles ``b tau_m + t_mc``, SSP-gated); every run of departures
        before a cloud update is one wave (``replay_departure``), every
        cloud update one staleness-weighted merge (``replay_merge``) and an
        eval point (``eval_every`` counts updates)."""
        sched = self.schedule
        if sched.problem is None:
            raise ValueError("mode='async' needs schedule.problem to derive "
                             "per-edge cycle times (eqs. 8/33)")
        rounds = rounds or sched.rounds
        part = part_hot = None
        if self.sampler is not None:
            # one cohort per cycle, drawn for the longest trace the gate
            # allows (later cycles clamp to the last row)
            part = self._participation_matrix(rounds + self.max_staleness)
            part_hot = self._participation_hot(part)
        if self.fault_model is not None:
            # the policy prices the full fleet; only the model's masks
            # compose with the cohort
            stats = delay.faulty_async_completion(
                sched.problem, sched.assoc, sched.a, sched.b, rounds=rounds,
                max_staleness=self.max_staleness,
                fault_model=self.fault_model, policy=self.fault_policy,
                delay_model=self.delay_model, key=self._fault_key())
            surv = self.hot_survivor_rows(stats["cycle_stats"].survivors)
            if part_hot is not None:
                surv = _combine_masks(surv, part_hot)
        else:
            stats = delay.async_completion(
                sched.problem, sched.assoc, sched.a, sched.b, rounds=rounds,
                max_staleness=self.max_staleness,
                delay_model=self.delay_model, key=self._delay_key(),
                participation=part)
            surv = part_hot
        tl = stats["timeline"]
        active = np.asarray(stats["active_edges"])
        gids, weights = self._hot_gids, self._hot_weights
        test = {k: torch.as_tensor(v, device=self.device)
                for k, v in test_batch.items()}

        g = self.cloud_vector()
        num_updates = len(tl.updates)
        pending = np.zeros(gids.shape[0], dtype=bool)
        # Under faults or sampling: each row's flag in its LAST departed
        # cycle's mask (the wave's weights renormalise to them) and each
        # edge's last departed cycle (a merge of a dead cohort is skipped).
        pending_ok = np.ones(gids.shape[0], dtype=bool)
        last_cycle = np.zeros(sched.num_edges, dtype=np.int64)
        times, accs, tlosses, trlosses = [], [], [], []
        updates_seen = 0
        for kind, ev in tl.trace:
            if kind == "depart":
                cohort = gids == int(active[ev.edge])
                pending |= cohort
                if surv is not None:
                    row = min(ev.cycle - 1, surv.shape[0] - 1)
                    pending_ok[cohort] = surv[row, cohort]
                    last_cycle[int(active[ev.edge])] = row
                continue
            if kind in ("fail", "repair"):
                continue        # clock annotations: a voided cycle's
                                # delivery never appears in the trace
            if pending.any():
                self.replay_departure(
                    g, pending, ue_ok=(None if surv is None else
                                       np.where(pending, pending_ok, True)))
                pending = np.zeros_like(pending)
            decay = np.zeros(sched.num_edges)
            for e, _, s in ev.merges:
                m = int(active[e])
                ok = 1.0
                if surv is not None:
                    cohort = gids == m
                    mass = (weights[cohort] *
                            surv[last_cycle[m], cohort]).sum()
                    ok = float(mass > 0)  # dead cohort: zero rows, no merge
                decay[m] = ok * self.staleness_decay ** s
            g = self.replay_merge(g, decay)
            updates_seen += 1
            if updates_seen % eval_every == 0 or updates_seen == num_updates:
                acc, loss, trl = self._evaluate(self.global_from_vector(g),
                                                test)
                times.append(ev.t)
                accs.append(acc)
                tlosses.append(loss)
                trlosses.append(trl)
                if verbose:
                    print(f"update {updates_seen:4d}/{num_updates}  "
                          f"t={ev.t:9.2f}s  acc={accs[-1]:.4f}  "
                          f"loss={tlosses[-1]:.4f}")
        # leave every row equal to the cloud model, so ``global_params``
        # and a further run see the merged state
        self._flat = g[self._cols][None, :].expand(
            self._flat.shape).contiguous()
        return SimResult(times=np.array(times), test_acc=np.array(accs),
                         test_loss=np.array(tlosses),
                         train_loss=np.array(trlosses), schedule=sched,
                         final_params=self.global_params(), timeline=tl)


def _stack(params: dict, n: int, device) -> dict:
    """Every leaf repeated along a new leading UE axis of size ``n``."""
    return {k: (_stack(v, n, device) if isinstance(v, dict) else
                torch.as_tensor(v, device=device).unsqueeze(0)
                .expand((n,) + tuple(v.shape)))
            for k, v in params.items()}


def _stack_to(stacked: dict, device) -> dict:
    """A nested dict of tensors or arrays as tensors on ``device``."""
    return {k: (_stack_to(v, device) if isinstance(v, dict) else
                torch.as_tensor(v, device=device))
            for k, v in stacked.items()}
