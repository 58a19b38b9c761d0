"""Simulation backend — Algorithm 1 with a simulated wall clock, ported
from the JAX package's ``repro/fl/sim.py`` (synchronous mode, one device).

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
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch
from torch.func import vmap

from repro_torch.core.schedule import HFLSchedule
from repro_torch.device import resolve_device
from repro_torch.fl import aggregate, clients
from repro_torch.fl.flatten import FlatLayout


@dataclasses.dataclass
class SimResult:
    times: np.ndarray          # (R,) cumulative simulated seconds per eval
    test_acc: np.ndarray       # (R,)
    test_loss: np.ndarray      # (R,)
    train_loss: np.ndarray     # (R,)
    schedule: HFLSchedule
    final_params: dict


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               f"(ROADMAP Queue 1 {item})")


class HFLSimulator:
    """Run Alg. 1 for a schedule over a federated dataset.

    loss_fn(params, batch) -> (loss, metrics) — one UE's full-batch loss.
    ``device=None`` runs on the CUDA card and raises if there is none.
    """

    def __init__(self, schedule: HFLSchedule, loss_fn: Callable,
                 init_params: dict, ue_data: List[dict], *,
                 lr: float = 0.05, solver: str = "gd",
                 samples_per_ue: Optional[int] = None, seed: int = 0,
                 mode: str = "sync", mesh=None, delay_model=None,
                 fault_model=None, sampler=None, device=None):
        if mode == "async":
            raise _not_ported("mode='async'", "item 7")
        if mode != "sync":
            raise ValueError(f"mode must be 'sync' or 'async', got {mode!r}")
        if solver == "dane":
            raise _not_ported("solver='dane'", "item 5")
        if solver != "gd":
            raise ValueError(f"solver must be 'gd' or 'dane', got {solver!r}")
        if mesh is not None:
            raise _not_ported("mesh=", "item 13")
        if delay_model is not None:
            raise _not_ported("delay_model=", "item 8")
        if fault_model is not None:
            raise _not_ported("fault_model=", "item 9")
        if sampler is not None:
            raise _not_ported("sampler=", "item 9")
        self.device = resolve_device(device)
        self.schedule = schedule
        self.loss_fn = loss_fn
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
        self.batches = {
            key: torch.as_tensor(np.stack([d[key][ix] for d, ix in
                                           zip(ue_data, resample)]),
                                 device=self.device)
            for key in ue_data[0]
        }                                            # leaves (N, k, ...)

        # Aggregation weights: the paper's D_n (eq. 6/10).
        w = (schedule.problem.samples if schedule.problem is not None
             else sizes)
        self.weights = torch.as_tensor(np.asarray(w, np.float32),
                                       device=self.device)
        self.group_ids = torch.as_tensor(
            schedule.assoc.argmax(1).astype(np.int32), device=self.device)

        stacked = _stack(init_params, n, self.device)
        self._layout = FlatLayout.of(stacked)
        if any(dt != torch.float32 for dt in self._layout.dtypes):
            # local GD writes the fp32 buffer through unravel's views, and
            # only fp32 leaves come back as views
            raise ValueError("init_params leaves must be float32, got "
                             f"{sorted(set(map(str, self._layout.dtypes)))}")
        self._flat = self._layout.ravel(stacked)
        self._local_gd = clients.gd_local_steps(loss_fn, schedule.a, lr)
        self._per_ue_loss = vmap(lambda p, bb: loss_fn(p, bb)[0],
                                 in_dims=(None, 0))

    # ------------------------------------------------------------------

    @property
    def params(self) -> dict:
        """Stacked UE replicas, unravelled from the flat buffer."""
        return self._layout.unravel(self._flat)

    def _cloud_round(self) -> None:
        s = self.schedule
        flat = self._flat
        for _ in range(s.b):
            # a local GD steps, written in place into `flat` through the
            # views that unravel returns
            self._local_gd(self._layout.unravel(flat), self.batches)
            flat = aggregate.flat_edge_aggregate(flat, self.weights,
                                                 self.group_ids, s.num_edges)
        self._flat = aggregate.flat_cloud_aggregate(flat, self.weights)

    def global_params(self) -> dict:
        """The cloud model: weighted mean over UE replicas (eq. 10)."""
        w = self.weights / self.weights.sum()
        return self._layout.unravel_single(w @ self._flat)

    def _train_loss(self, gp) -> torch.Tensor:
        """Weight-averaged train loss over ALL UEs."""
        w = self.weights / self.weights.sum()
        return (w * self._per_ue_loss(gp, self.batches)).sum()

    def run(self, test_batch: dict, rounds: Optional[int] = None,
            eval_every: int = 1, verbose: bool = False) -> SimResult:
        """Execute ``rounds`` synchronous cloud rounds."""
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
                with torch.no_grad():
                    gp = self.global_params()
                    loss, mets = self.loss_fn(gp, test)
                    trl = self._train_loss(gp)
                times.append(clock)
                accs.append(float(mets.get("acc", float("nan"))))
                tlosses.append(float(loss))
                trlosses.append(float(trl))
                if verbose:
                    print(f"round {r+1:3d}/{rounds}  t={clock:9.2f}s  "
                          f"acc={accs[-1]:.4f}  loss={tlosses[-1]:.4f}")
        return SimResult(times=np.array(times), test_acc=np.array(accs),
                         test_loss=np.array(tlosses),
                         train_loss=np.array(trlosses),
                         schedule=sched, final_params=self.global_params())


def _stack(params: dict, n: int, device) -> dict:
    """Every leaf repeated along a new leading UE axis of size ``n``."""
    return {k: (_stack(v, n, device) if isinstance(v, dict) else
                torch.as_tensor(v, device=device).unsqueeze(0)
                .expand((n,) + tuple(v.shape)))
            for k, v in params.items()}
