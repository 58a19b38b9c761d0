"""Entry ``serve_decode``: batches of B sequences decoded greedily through
the step of ``repro_torch.launch.steps.make_serve_step(model)``, over the
cache that ``Model.prefill`` builds.

Set-up draws the weights from the seed on the device, makes the prompts
from the seed, prefills the first batch and runs the traffic's warm-up
steps.  A unit of the window is one decode step: the step's call, then
its B tokens copied to host memory (a streaming server's return).  A
batch that has all its output tokens is replaced by a fresh batch, whose
prefill (and first tokens) falls inside that unit: its time counts in
the window, and it is no inter-token gap (a gap is the time between two
tokens of one batch reaching host memory).  Every served token is kept on
the host for the check.
"""
from __future__ import annotations

import contextlib
import sys
import time

import numpy as np

from harness import serving
from harness.loop import closed_loop


class Entry:
    #: the control: the reference in float8 in the program's place
    CONTROLS = {"fp8": {"mode": "fp8"}}

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config
        self.t = ctx.traffic
        self._spans = contextlib.ExitStack()
        self.routes = serving.Routes()
        self.issue_s = []
        self.gaps_s = []
        self.last_tok = None             # host time of the newest token
        self.slice_counted = []

    def setup(self) -> None:
        from repro_torch.launch.steps import make_serve_step
        t = self.t
        self.model, self.weights = serving.build(self.cfg, self.ctx,
                                                 t["decode_margin"])
        self.step = make_serve_step(self.model)
        self.pool = serving.prompts(self.cfg, self.ctx,
                                    t["prompt_pool"] * t["batch"],
                                    t["prompt_len"]).reshape(
            t["prompt_pool"], t["batch"], t["prompt_len"])
        if self.ctx.trace:
            self._spans.enter_context(serving.moe_spans(self.routes))
        self.batches = []                # (pool index, [host tokens (B,)])
        self._new_batch()
        for _ in range(t["warmup_steps"]):
            self._step()
        self.issue_s.clear()
        self.gaps_s.clear()

    def _new_batch(self) -> None:
        import torch
        i = len(self.batches) % self.pool.shape[0]
        self.state = None
        logits, self.state = self.model.prefill(self.weights,
                                                {"tokens": self.pool[i]})
        self.tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        self.batches.append((i, [self.tok[:, 0].cpu().numpy()]))
        self.last_tok = time.perf_counter()

    def _step(self) -> None:
        t0 = time.perf_counter()
        self.tok, self.state = self.step(self.weights, self.state, self.tok)
        self.issue_s.append(time.perf_counter() - t0)
        out = self.batches[-1][1]
        out.append(self.tok[:, 0].cpu().numpy())
        now = time.perf_counter()
        if self.last_tok is not None:
            self.gaps_s.append(now - self.last_tok)
        self.last_tok = now
        if len(out) >= self.t["max_new"]:
            self._new_batch()

    def _left(self) -> int:
        """Steps before the current batch has all its output tokens."""
        return self.t["max_new"] - len(self.batches[-1][1])

    def _ready(self) -> bool:
        """Whether the profiled slice fits in the current batch, so that it
        holds decode steps alone and no fresh batch's prefill."""
        return self._left() > self.t["profile_steps"]

    def _profiled(self) -> None:
        self.slice_counted = []          # the last profiled slice's alone
        self.routes.clear()
        self.routes.recording = True
        issued, gapped = len(self.issue_s), len(self.gaps_s)
        try:
            for _ in range(min(self.t["profile_steps"], self._left() - 1)):
                self.slice_counted.append(self.t["prompt_len"]
                                          + len(self.batches[-1][1]))
                self._step()
        finally:
            self.routes.recording = False
            del self.issue_s[issued:]     # host times under the profiler
            del self.gaps_s[gapped:]
            # the next gap would span the profiler's reading of the slice
            self.last_tok = None

    def window(self, seconds: float) -> dict:
        self.issue_s.clear()
        self.gaps_s.clear()
        profile = self._profiled if self.ctx.trace else None
        n0, b0 = sum(len(o) for _, o in self.batches), len(self.batches)
        self.last_tok = time.perf_counter()
        rec = closed_loop(self._step, seconds, profile,
                          spans=(serving.MOE_SPAN,) if self.ctx.trace else (),
                          ready=self._ready)
        served = sum(len(o) for _, o in self.batches) - n0
        gaps = np.sort(self.gaps_s) * 1e3
        print("decode gaps ms: p50 %.3f p90 %.3f p95 %.3f p99 %.3f max %.3f;"
              " %d fresh batches in the window"
              % (*np.quantile(gaps, [0.5, 0.9, 0.95, 0.99, 1.0]),
                 len(self.batches) - b0), file=sys.stderr)
        steps = len(self.slice_counted)
        layers = self.cfg["num_hidden_layers"]
        rec.update({"kind": "decode", "sizes": serving.sizes(self.cfg),
                    "batch": self.t["batch"],
                    "tokens": (served - steps) * self.t["batch"],
                    "gaps_s": list(self.gaps_s),
                    "issue_s": list(self.issue_s),
                    "ring": self.t["prompt_len"] + self.t["decode_margin"],
                    # the profiled steps' counted slots and, a step, the
                    # distinct experts their tokens picked over the layers
                    "slice_counted": list(self.slice_counted),
                    "experts_picked": (self.routes.distinct() * layers
                                       / len(self.routes))
                    if self.routes else None})
        return rec

    def attempted_failed(self, rec) -> tuple:
        return rec["units"], 0

    def free(self) -> None:
        self._spans.close()
        self.state = self.tok = None
        self.model = self.step = None
        self.routes.clear()

    def sample(self) -> list:
        """The batch the check compares, every row of it: the one with the
        most served tokens (the capacity couples a step's rows, so a row
        is not judged alone)."""
        return [max(range(len(self.batches)),
                    key=lambda b: len(self.batches[b][1]))]

    def reference_gaps(self, b: int, mode: str = "fp32") -> np.ndarray:
        """For batch ``b``, the reference's logits at every served
        position, teacher-forced on the prompt and the served tokens: the
        gap (B, n) by which each served token lies below the reference's
        best, over that position's standard deviation of the reference's
        logits.  ``mode="fp8"``: the gap of the token the float8 reference
        puts first (the control)."""
        import torch
        from reference import qwen_moe
        c = serving.sizes(self.cfg)
        i, out = self.batches[b]
        served = torch.as_tensor(np.stack(out, 1), device=self.ctx.device)
        prompt = self.pool[i]
        S, n = prompt.shape[1], served.shape[1]
        toks = torch.cat([prompt, served[:, :-1].to(prompt.dtype)], 1)
        groups = [(0, S)] + [(p, p + 1) for p in range(S, S + n - 1)]
        with torch.no_grad():
            h = qwen_moe.hidden(c, self.weights, toks, groups)
            hc = (qwen_moe.hidden(c, self.weights, toks, groups, mode)
                  if mode != "fp32" else None)
            gaps = []
            for r in range(toks.shape[0]):
                ref = qwen_moe.logits(c, self.weights, h[r, S - 1:])
                if hc is None:
                    pick = served[r].long()
                else:
                    pick = qwen_moe.logits(c, self.weights, hc[r, S - 1:],
                                           mode).argmax(-1)
                g = (ref.max(-1).values - ref.gather(-1, pick[:, None])[:, 0]) \
                    / ref.std(-1)
                gaps.append(g.cpu().numpy())
                del ref
        return np.stack(gaps)

    def check(self, mode: str = "fp32") -> dict:
        """The widest gap of a served token under the reference's best,
        over all served positions of the sampled batches."""
        gaps = np.concatenate([self.reference_gaps(b, mode).ravel()
                               for b in self.sample()])
        return {"gap_mean": float(gaps.mean()),
                "_gap_max": float(gaps.max()),
                "_gap_p99": float(np.quantile(gaps, 0.99)),
                "_below_best": float((gaps > 0).mean()),
                "_positions": int(gaps.size)}
