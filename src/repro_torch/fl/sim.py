"""Simulation backend — Algorithm 1 with a simulated wall clock, ported
from the JAX package's ``repro/fl/sim.py`` (sync and async modes on one
device; sync mode on a mesh of ranks).

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

Pass ``mesh=`` (a ``repro_torch.launch.mesh.AggMesh``; sync mode) and the
run is data-sharded over ``torch.distributed`` ranks, as the reference's
``shard_map`` run is over devices.  Every rank builds the simulator from
the same full ``ue_data`` and calls ``run`` in step with the others; it
keeps only its slab of the padded ``ShardedFlatLayout`` buffer (whole
edges' UE rows, a column slab) and its rows of the batches, weights and
group ids (pad rows: row-0 copies with weight 0, trained like any row).
Under a model axis a rank all-gathers its rows' column slabs before local
training and keeps its own columns after.  Edge events need no
collective; each cloud event is one ``weighted_mean`` launch and one
all-reduce over 'data'.  ``params``, ``global_params`` and the losses are
global (collectives at eval boundaries), so ``run`` returns the same
``SimResult`` on every rank.

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
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.func import vmap

from repro_torch.core import delay
from repro_torch.core.schedule import HFLSchedule
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


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               f"(ROADMAP Queue 1 {item})")


class HFLSimulator:
    """Run Alg. 1 for a schedule over a federated dataset.

    loss_fn(params, batch) -> (loss, metrics) — one UE's full-batch loss.
    ``device=None`` runs on the CUDA card and raises if there is none
    (under a mesh: on the mesh's device).  ``mesh=`` (sync mode): this
    rank's ``AggMesh``; see the module docstring.
    """

    def __init__(self, schedule: HFLSchedule, loss_fn: Callable,
                 init_params: dict, ue_data: List[dict], *,
                 lr: float = 0.05, solver: str = "gd",
                 dane_mu: float = 0.1, samples_per_ue: Optional[int] = None,
                 seed: int = 0, mode: str = "sync",
                 max_staleness: Optional[int] = 0,
                 staleness_decay: float = 0.9, mesh=None, delay_model=None,
                 fault_model=None, sampler=None, device=None):
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
        if mesh is not None and mode == "async":
            raise _not_ported("mode='async' with mesh= (the staleness "
                              "merge on a mesh)", "item 13b")
        if delay_model is not None:
            raise _not_ported("delay_model=", "item 8")
        if fault_model is not None:
            raise _not_ported("fault_model=", "item 9")
        if sampler is not None:
            raise _not_ported("sampler=", "item 9")
        self.mesh = mesh
        self.device = resolve_device(
            mesh.device if mesh is not None and device is None else device)
        self.schedule = schedule
        self.loss_fn = loss_fn
        self.solver = solver
        self.mode = mode
        self.max_staleness = int(max_staleness)
        self.staleness_decay = float(staleness_decay)
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
        # The rows this simulator (rank) trains: all N in original order,
        # or under a mesh the rank's padded, group-aligned rows.
        if mesh is None:
            self._slayout = None
            self._flat = self._layout.ravel(stacked)
        else:
            sl = ShardedFlatLayout.build(self._layout, mesh, n,
                                         group_ids=gids)
            self._slayout = sl
            self._flat = sl.local(sl.ravel(stacked))
            batches = {k: sl.pad_rows(v)[sl.local_rows]
                       for k, v in batches.items()}
            w = sl.pad_weights(w)[sl.local_rows].numpy()
            gids = sl.pad_rows(gids)[sl.local_rows]
        self.batches = {k: torch.as_tensor(v, device=self.device)
                        for k, v in batches.items()}
        self.weights = torch.as_tensor(w, device=self.device)
        self.group_ids = torch.as_tensor(gids, device=self.device)
        self._local_gd = clients.gd_local_steps(loss_fn, schedule.a, lr)
        self._local_dane = clients.dane_local_steps(loss_fn, schedule.a, lr,
                                                    mu_prox=dane_mu)
        self._w_total = float(self.weights.sum())
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
        parts = [torch.empty_like(self._flat) for _ in range(self.mesh.size)]
        dist.all_gather(parts, self._flat.contiguous())
        nm = self.mesh.num_model
        full = torch.cat([torch.cat(parts[i:i + nm], 1)
                          for i in range(0, len(parts), nm)], 0)
        return self._slayout.unravel(full)

    @property
    def _data_group(self):
        return None if self.mesh is None else self.mesh.data_group

    def _gather_cols(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` with the other model ranks' column slabs beside it (last
        axis, in model order); ``t`` itself without a model axis."""
        if self.mesh is None or self.mesh.num_model == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(self.mesh.num_model)]
        dist.all_gather(parts, t.contiguous(), group=self.mesh.model_group)
        return torch.cat(parts, -1)

    def _single_device(self, what: str) -> None:
        if self.mesh is not None:
            raise _not_ported(f"{what} with mesh=", "item 13b")

    def _edge_rounds(self, flat: torch.Tensor) -> torch.Tensor:
        """b edge rounds on every row of ``flat``: a local steps, written
        in place into ``flat`` through the views that unravel returns, then
        the eq. 6 edge aggregation."""
        s = self.schedule
        for _ in range(s.b):
            rows = self._gather_cols(flat)
            p = self._layout.unravel(rows)
            if self.solver == "dane":
                g_bar = clients.global_gradient(self.loss_fn, p,
                                                self.batches, self.weights,
                                                group=self._data_group)
                self._local_dane(p, self.batches, g_bar)
            else:
                self._local_gd(p, self.batches)
            if rows is not flat:          # the gathered rows are a copy
                flat.copy_(rows[:, self._slayout.local_cols])
            flat = aggregate.flat_edge_aggregate(
                flat, self.weights, self.group_ids, s.num_edges,
                mesh=self.mesh)
        return flat

    def _cloud_round(self) -> None:
        self._flat = aggregate.flat_cloud_aggregate(
            self._edge_rounds(self._flat), self.weights, mesh=self.mesh)

    def _depart_cycle(self, g: torch.Tensor, mask: torch.Tensor) -> None:
        """Re-seed the departing rows (``mask``) from the cloud vector
        ``g``, run the b-iteration edge cycle (Alg. 1 lines 4-9) and commit
        ONLY the masked rows; mid-flight edges' rows pass through.  As in
        the JAX package the wave trains the WHOLE buffer and drops the
        unmasked rows, so a wave costs a sync round's training.  The cycle
        runs on the fresh seeded copy, never on ``self._flat``: local GD
        writes in place, and the rows of edges in flight must not move."""
        seeded = torch.where(mask[:, None], g[None, :], self._flat)
        self._flat = torch.where(mask[:, None], self._edge_rounds(seeded),
                                 self._flat)

    def global_params(self) -> dict:
        """The cloud model: weighted mean over UE replicas (eq. 10).  Under
        a mesh a collective (one all-reduce over 'data', one all-gather
        over 'model'): every rank must call it."""
        if self.mesh is None:
            w = self.weights / self.weights.sum()
            return self._layout.unravel_single(w @ self._flat)
        mean = aggregate.psum_weighted_mean(
            self.weights @ self._flat, self.weights.sum(), self._data_group)
        return self._layout.unravel_single(self._gather_cols(mean))

    def _train_loss(self, gp) -> torch.Tensor:
        """Weight-averaged train loss over ALL UEs (under a mesh, each
        rank's rows' weighted sum, then one all-reduce over 'data')."""
        losses = self._per_ue_loss(gp, self.batches)
        if self.mesh is None:
            w = self.weights / self.weights.sum()
            return (w * losses).sum()
        return aggregate.psum_weighted_mean(
            (self.weights * losses).sum().reshape(1), self.weights.sum(),
            self._data_group)[0]

    def _evaluate(self, gp, test: dict):
        """(test accuracy, test loss, train loss) of the global model."""
        with torch.no_grad():
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
        round_times = np.full(rounds, sched.cloud_round_time)  # eq. (34)
        test = {k: torch.as_tensor(v, device=self.device)
                for k, v in test_batch.items()}
        times, accs, tlosses, trlosses = [], [], [], []
        clock = 0.0
        for r in range(rounds):
            self._cloud_round()
            clock += float(round_times[r])
            if (r + 1) % eval_every == 0 or r == rounds - 1:
                acc, loss, trl = self._evaluate(self.global_params(), test)
                times.append(clock)
                accs.append(acc)
                tlosses.append(loss)
                trlosses.append(trl)
                if verbose:
                    print(f"round {r+1:3d}/{rounds}  t={clock:9.2f}s  "
                          f"acc={accs[-1]:.4f}  loss={tlosses[-1]:.4f}")
        return SimResult(times=np.array(times), test_acc=np.array(accs),
                         test_loss=np.array(tlosses),
                         train_loss=np.array(trlosses),
                         schedule=sched, final_params=self.global_params())

    # ------------------------------------------------------------------
    # Replay hooks (mode='async'): the event-replay primitives
    # ``_run_async`` is built from, public so a driver can advance the same
    # model state one event at a time, checkpoint it and resume.
    # ------------------------------------------------------------------

    def cloud_vector(self) -> torch.Tensor:
        """(F,) fp32 cloud model: the weighted mean of the flat buffer."""
        self._single_device("cloud_vector")
        w = self.weights.cpu().numpy()
        return torch.as_tensor(w / w.sum(), dtype=torch.float32,
                               device=self.device) @ self._flat

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
        ``mask`` is an (N,) bool over rows (the departing cohorts)."""
        if self.mode != "async":
            raise RuntimeError("replay_departure requires mode='async'")
        if ue_ok is not None or agg_weights is not None:
            raise _not_ported("replay_departure(ue_ok=, agg_weights=)",
                              "items 9 and 12")
        self._depart_cycle(self.place_cloud_vector(g),
                           torch.as_tensor(mask, dtype=torch.bool,
                                           device=self.device))

    def replay_merge(self, g, decay) -> torch.Tensor:
        """Staleness-weighted cloud merge of the arrived edges.  ``decay``
        is (M,) float64, ``staleness_decay ** lag`` for arrived edges and
        0 elsewhere; returns the updated cloud vector."""
        if self.mode != "async":
            raise RuntimeError("replay_merge requires mode='async'")
        gids = self.group_ids.cpu().numpy()
        eff = (self.weights.cpu().numpy() * np.asarray(decay)[gids]
               ).astype(np.float32)
        return aggregate.flat_staleness_merge(
            self.place_cloud_vector(g), self._flat, eff, self._w_total)

    def edge_mean_row(self, m: int) -> torch.Tensor:
        """(F,) fp32: edge ``m``'s model right after its cycle's eq. 6
        aggregation (every member row holds the edge mean)."""
        self._single_device("edge_mean_row")
        idx = int(np.flatnonzero(self.group_ids.cpu().numpy() == int(m))[0])
        return self._flat[idx]

    def edge_mass(self, m: int) -> float:
        """Total aggregation weight of edge ``m``'s cohort (float64)."""
        self._single_device("edge_mass")
        w = self.weights.cpu().numpy().astype(np.float64)
        return float(w[self.group_ids.cpu().numpy() == int(m)].sum())

    def hot_rows(self, idx) -> np.ndarray:
        """Host copy of the given flat-buffer rows: (len(idx), F) fp32."""
        self._single_device("hot_rows")
        idx = torch.as_tensor(np.asarray(idx, np.int64), device=self.device)
        return self._flat[idx].cpu().numpy()

    def global_from_vector(self, g) -> dict:
        """Unravel a cloud vector into the global parameter dict."""
        return self._layout.unravel_single(self.place_cloud_vector(g))

    def flat_state(self) -> np.ndarray:
        """Host copy of the flat buffer (checkpoint payload)."""
        self._single_device("flat_state")
        return self._flat.cpu().numpy().copy()

    def set_flat_state(self, flat) -> None:
        """Restore the flat buffer from a host array, such as the JAX
        package's ``HFLSimulator.flat_state()``."""
        self._single_device("set_flat_state")
        flat = np.array(flat, np.float32)    # local GD writes in place
        if flat.shape != tuple(self._flat.shape):
            raise ValueError(f"flat buffer shape {flat.shape} does not "
                             f"match this simulator's layout "
                             f"{tuple(self._flat.shape)}")
        self._flat = torch.as_tensor(flat, device=self.device)

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
        stats = delay.async_completion(
            sched.problem, sched.assoc, sched.a, sched.b, rounds=rounds,
            max_staleness=self.max_staleness)
        tl = stats["timeline"]
        active = np.asarray(stats["active_edges"])
        gids = self.group_ids.cpu().numpy()
        test = {k: torch.as_tensor(v, device=self.device)
                for k, v in test_batch.items()}

        g = self.cloud_vector()
        num_updates = len(tl.updates)
        pending = np.zeros(gids.shape[0], dtype=bool)
        times, accs, tlosses, trlosses = [], [], [], []
        updates_seen = 0
        for kind, ev in tl.trace:
            if kind == "depart":
                pending |= gids == int(active[ev.edge])
                continue
            if pending.any():
                self.replay_departure(g, pending)
                pending = np.zeros_like(pending)
            decay = np.zeros(sched.num_edges)
            for e, _, s in ev.merges:
                decay[int(active[e])] = self.staleness_decay ** s
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
        self._flat = g[None, :].expand(self._flat.shape).contiguous()
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
