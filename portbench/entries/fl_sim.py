"""Entry ``fl_sim``: Algorithm 1 on LeNet through
``repro_torch.fl.sim.HFLSimulator.run``, one cloud round a unit.

Set-up draws the data and the weights from the seed on the device, builds
the simulator for the configuration's fleet and plan, and runs the
traffic's ``check_rounds`` first rounds through the window's own call
(``run(test, rounds=1)``): they warm every shape up and are what the
reference follows.  The window then goes on with that same simulator.
"""
from __future__ import annotations

import contextlib
import math
from unittest import mock

import numpy as np

from harness.loop import closed_loop

GD_SPAN = "pb.gd"


class Entry:
    #: the control (the reference in TF32 in the program's place) and the
    #: faults read against it (``controls/calibrate.py``)
    CONTROLS = {"tf32": {"control": {"mode": "tf32"}},
                "half_batch": {"control": {"half_batch": True}}}

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config
        self.traffic = ctx.traffic
        self._patches = contextlib.ExitStack()

    # -- set-up ------------------------------------------------------------

    def _weights(self, gen):
        """LeNet's parameters from ``gen`` on the device: convolutions
        N(0, 0.1^2) (HWIO), dense layers N(0, 2 / fan-in), biases 0."""
        import torch
        m = self.cfg["model"]
        c1, c2 = m["conv_channels"]
        k, cin = m["kernel_size"], m["in_channels"]
        f1, f2 = m["fc_dims"]
        s = m["image_size"]
        s2 = ((s - k + 1) // 2 - k + 1) // 2
        dev = gen.device

        def normal(shape, std):
            return torch.randn(shape, generator=gen, device=dev).mul_(std)

        def dense(i, o):
            return {"w": normal((i, o), math.sqrt(2.0 / i)),
                    "b": torch.zeros(o, device=dev)}

        return {"conv1": {"w": normal((k, k, cin, c1), 0.1),
                          "b": torch.zeros(c1, device=dev)},
                "conv2": {"w": normal((k, k, c1, c2), 0.1),
                          "b": torch.zeros(c2, device=dev)},
                "fc1": dense(s2 * s2 * c2, f1), "fc2": dense(f1, f2),
                "out": dense(f2, m["num_classes"])}

    def setup(self) -> None:
        import torch
        from data.synthetic import class_gaussian_images, size_partition
        from repro_torch.core import delay
        from repro_torch.core.problem import HFLProblem
        from repro_torch.core.schedule import HFLSchedule
        from repro_torch.fl import clients
        from repro_torch.fl.sim import HFLSimulator
        from repro_torch.models.lenet import lenet_loss

        cfg, ctx = self.cfg, self.ctx
        dev = torch.device(ctx.device)
        plan = cfg["plan"]
        a, b = int(plan["a"]), int(plan["b"])
        prob = HFLProblem(**cfg["fleet"])
        gid = np.asarray(plan["edge_of_ue"])
        assoc = np.zeros((prob.num_ues, prob.num_edges), np.int64)
        assoc[np.arange(prob.num_ues), gid] = 1
        T = delay.cloud_round_time(prob, assoc, a, b)
        sched = HFLSchedule(a=a, b=b, rounds=1, assoc=assoc, total_delay=T,
                            cloud_round_time=T,
                            edge_round_time=delay.edge_round_time(prob, assoc,
                                                                  a),
                            problem=prob)

        d, m = cfg["data"], cfg["model"]
        gen = torch.Generator(device=dev).manual_seed(ctx.seed["torch"])
        imgs, labels = class_gaussian_images(
            gen, d["n_train"] + d["n_test"], num_classes=m["num_classes"],
            size=m["image_size"], channels=m["in_channels"],
            noise=d["noise"], mean_seed=d["class_mean_seed"])
        ntr = d["n_train"]
        self.test = {"images": imgs[ntr:], "labels": labels[ntr:]}
        x_np, y_np = imgs[:ntr].cpu().numpy(), labels[:ntr].cpu().numpy()
        parts = size_partition(np.random.default_rng(ctx.seed["numpy"]), ntr,
                               prob.samples.astype(int))
        self.ue_data = [{"images": x_np[ix], "labels": y_np[ix]}
                        for ix in parts]
        params = self._weights(gen)
        self.p0 = {k: {kk: v.clone() for kk, v in layer.items()}
                   for k, layer in params.items()}
        self.a, self.b, self.gid = a, b, gid

        self.profiling = False
        if ctx.trace:
            gd = clients.gd_local_steps
            sync = (torch.cuda.synchronize if dev.type == "cuda"
                    else (lambda: None))

            def annotated_gd(*args, **kw):
                run = gd(*args, **kw)

                def spanned(*a_, **k_):
                    if not self.profiling:
                        return run(*a_, **k_)
                    sync()
                    with torch.profiler.record_function(GD_SPAN):
                        out = run(*a_, **k_)
                        sync()
                    return out
                return spanned
            self._patches.enter_context(
                mock.patch.object(clients, "gd_local_steps", annotated_gd))

        tr = self.traffic
        self.sim = HFLSimulator(
            sched, lenet_loss, params, self.ue_data, lr=cfg["lr"],
            samples_per_ue=cfg["samples_per_ue"], seed=ctx.seed["u32"],
            mode=tr["mode"], max_staleness=tr["max_staleness"],
            staleness_decay=tr["staleness_decay"], device=dev)
        self.first = []
        for r in range(tr["check_rounds"]):
            res = self.sim.run(self.test, rounds=1)
            self.first.append({
                "train_loss": float(res.train_loss[0]),
                "test_loss": float(res.test_loss[0]),
                "time": float(res.times[0]),
                "params": {k: {kk: v.detach().clone() for kk, v in l.items()}
                           for k, l in res.final_params.items()}})

    # -- window ------------------------------------------------------------

    def _round(self):
        self.sim.run(self.test, rounds=1)

    def _profiled(self):
        self.profiling = True
        try:
            self._round()
        finally:
            self.profiling = False

    def window(self, seconds: float) -> dict:
        profile = self._profiled if self.ctx.trace else None
        rec = closed_loop(self._round, seconds, profile,
                          spans=(GD_SPAN,) if self.ctx.trace else ())
        rec.update(self.work())
        return rec

    def work(self) -> dict:
        """What one unit is, for the metrics' arithmetic."""
        s = self.sim
        return {"kind": "fl_round", "model": self.cfg["model"],
                "num_ues": s.schedule.num_ues,
                "num_edges": s.schedule.num_edges,
                "samples_per_ue": int(s.batches["labels"].shape[1]),
                "params": int(s._layout.total), "a": self.a, "b": self.b,
                "eval_samples": int(self.test["labels"].shape[0]
                                    + s.batches["labels"].numel())}

    def attempted_failed(self, rec) -> tuple:
        return rec["units"], 0

    # -- check -------------------------------------------------------------

    def free(self) -> None:
        self._patches.close()
        self.sim = None

    def reference(self, mode: str = "fp32", half_batch: bool = False):
        """The reference's first rounds from the same weights and samples
        (``mode="tf32"``: the control; ``half_batch``: a fault), and its
        clock."""
        import torch
        from reference import hfl_clock, lenet_hfl
        cfg, dev = self.cfg, torch.device(self.ctx.device)
        k = cfg["samples_per_ue"]
        sizes = [len(d["labels"]) for d in self.ue_data]
        picks = lenet_hfl.resample(sizes, k, self.ctx.seed["u32"])
        stack = lambda key: torch.as_tensor(np.stack(
            [d[key][ix] for d, ix in zip(self.ue_data, picks)]), device=dev)
        fl = hfl_clock.fleet(**cfg["fleet"])
        ref = lenet_hfl.run(self.p0, stack("images"), stack("labels"),
                            fl["samples"], self.gid, self.a, self.b,
                            cfg["lr"], len(self.first), self.test,
                            mode=mode, half_batch=half_batch)
        return ref, hfl_clock.cloud_round_time(fl, self.gid, self.a, self.b)

    def check(self, control: dict = None) -> dict:
        """The first rounds' train losses, the first round's and the first
        three's change of each leaf, and the clock, against the reference
        run from the same weights and samples.  ``control`` puts the
        reference, run so (``{"mode": "tf32"}``, ``{"half_batch": True}``),
        in the program's place."""
        ref, T = self.reference()
        got = self.first
        if control is not None:
            other, _ = self.reference(**control)
            got = [{**r, "time": f["time"]} for r, f in zip(other, self.first)]
        return compare(self.p0, got, ref, T)


def compare(p0: dict, got: list, ref: list, T: float) -> dict:
    """The numbers the check holds to their limits (see ``check``)."""
    from reference import lenet_hfl
    loss = max(abs(f["train_loss"] - r["train_loss"]) / abs(r["train_loss"])
               for f, r in zip(got, ref))
    step1, leaf1, _ = lenet_hfl.norm_gaps(p0, got[0]["params"],
                                          ref[0]["params"])
    step3, leaf3, _ = lenet_hfl.norm_gaps(p0, got[-1]["params"],
                                          ref[-1]["params"])
    clock = max(abs(f["time"] - T) / T for f in got)
    return {"loss": loss, "step1": step1, "step3": step3, "clock": clock,
            "_worst_leaves": f"{leaf1} {leaf3}"}
