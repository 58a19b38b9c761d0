"""Entry ``serve_prefill``: requests of B long prompts through
``repro_torch.models.model.Model.prefill``, each ending at its first
token (the argmax of its last logits, copied to host memory).

Set-up draws the weights from the seed on the device, makes a pool of
prompts from the seed, and serves one request (every shape warmed up).
The window serves the pool's requests in turn; each request's last logits
are kept on the device for the check.
"""
from __future__ import annotations

import contextlib

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

    def setup(self) -> None:
        t = self.t
        self.model, self.weights = serving.build(self.cfg, self.ctx,
                                                 t["decode_margin"])
        self.pool = serving.prompts(self.cfg, self.ctx,
                                    t["prompt_pool"] * t["batch"],
                                    t["prompt_len"]).reshape(
            t["prompt_pool"], t["batch"], t["prompt_len"])
        if self.ctx.trace:
            self._spans.enter_context(serving.moe_spans())
        self.served = []        # (pool index, last logits, first tokens)
        self.kv = {}            # sampled request -> its compared layers' K, V
        self.keep = set()
        self._request()                  # warm-up: every shape once
        self.served.clear()
        self.keep = self._drawn()

    def _drawn(self) -> set:
        """The requests the check compares, drawn from the seed before the
        window among the first ``check_within`` it will serve."""
        rng = np.random.default_rng(self.ctx.seed["numpy"] + 1)
        return set(rng.choice(self.t["check_within"],
                              size=self.t["check_requests"],
                              replace=False).tolist())

    def _request(self) -> None:
        import torch
        n = len(self.served)
        i = n % self.pool.shape[0]
        logits, state = self.model.prefill(self.weights,
                                           {"tokens": self.pool[i]})
        first = torch.argmax(logits[:, -1], -1).to(torch.int32).cpu()
        if n in self.keep:
            S, st = self.t["prompt_len"], state["scanned"]
            self.kv[n] = {i: {"k": st["k"][i][:, :S].clone(),
                              "v": st["v"][i][:, :S].clone()}
                          for i in self._kv_layers()}
        del state
        self.served.append((i, logits[:, -1], first))

    def window(self, seconds: float) -> dict:
        profile = self._request if self.ctx.trace else None
        rec = closed_loop(self._request, seconds, profile,
                          spans=(serving.MOE_SPAN,) if self.ctx.trace else ())
        c = serving.sizes(self.cfg)
        rec.update({"kind": "prefill", "sizes": c, "batch": self.t["batch"],
                    "prompt_len": self.t["prompt_len"],
                    "tokens": rec["units"] * self.t["batch"]
                    * self.t["prompt_len"]})
        return rec

    def attempted_failed(self, rec) -> tuple:
        return rec["units"], 0

    def free(self) -> None:
        self._spans.close()
        self.model = None

    def _kv_layers(self) -> tuple:
        """The layers whose K/V cache the check compares: the second (the
        first layer's attention and MoE behind it, before route flips
        pile up) and the last (every layer before it behind it)."""
        return tuple(sorted({1, self.cfg["num_hidden_layers"] - 1}))

    def sample(self) -> list:
        """The requests the check compares (drawn before the window) that
        were served."""
        return sorted(i for i in self.keep if i < len(self.served))

    def reference(self, idx: int, mode: str = "fp32"):
        """The reference's last logits (B, V) of served request ``idx`` and
        its compared layers' keys and values."""
        import torch
        from reference import qwen_moe
        c = serving.sizes(self.cfg)
        toks = self.pool[self.served[idx][0]]
        kv = dict.fromkeys(self._kv_layers())
        with torch.no_grad():
            h = qwen_moe.hidden(c, self.weights, toks,
                                [(0, toks.shape[1])], mode, kv)
            return qwen_moe.logits(c, self.weights, h[:, -1], mode), kv

    def reference_logits(self, idx: int, mode: str = "fp32"):
        return self.reference(idx, mode)[0]

    def check(self, mode: str = "fp32") -> dict:
        """Each sampled request's outputs against the reference's, held
        row by row (a fault in one row of a batch shows in that row
        alone): for every row, quantiles of the vector errors of the K/V
        cache that the prefill built at the compared layers, and the RMS
        gap of its last logits over the reference's spread of them, with
        the served first token's gap below the reference's best.  The
        compared numbers are the worst row's median at the second layer
        (``kv1_worst_row``) and its 1st percentile at the last layer
        (``kv_last_q01_worst_row``: route flips move some of a row's
        vectors far, a fault moves them all), and the best row's logit
        error (``logit_err_min``); the rest are readings.
        ``mode="fp8"`` puts the reference in float8 in the program's
        place (the control)."""
        first, last = self._kv_layers()[0], self._kv_layers()[-1]
        errs, gaps, kv1, kvl = [], [], [], []
        for idx in self.sample():
            ref, ref_kv = self.reference(idx)
            if mode == "fp32":
                got, got_kv = self.served[idx][1].float(), self.kv[idx]
                pick = self.served[idx][2].to(ref.device).long()
            else:
                got, got_kv = self.reference(idx, mode)
                pick = got.argmax(-1)
            e, g = logit_gaps(got, ref, pick)
            errs.append(e)
            gaps.append(g)
            kv1.append(row_errors(got_kv[first], ref_kv[first], (0.5,)))
            kvl.append(row_errors(got_kv[last], ref_kv[last], (0.5, 0.01)))
            del ref, got, ref_kv, got_kv
        errs, gaps = np.concatenate(errs), np.concatenate(gaps)
        kv1, kvl = np.concatenate(kv1), np.concatenate(kvl)

        def rows(x):
            return [round(float(v), 5) for v in x]
        return {"kv1_worst_row": float(kv1[:, 0].max()),
                "kv_last_q01_worst_row": float(kvl[:, 1].max()),
                "logit_err_min": float(errs.min()),
                "_kv1_rows_q50": rows(kv1[:, 0]),
                "_kv_last_rows_q50": rows(kvl[:, 0]),
                "_kv_last_rows_q01": rows(kvl[:, 1]),
                "_logit_err_max": float(errs.max()),
                "_gap_max": float(gaps.max()),
                "_err_rows": rows(errs)}


def logit_gaps(got, ref, pick=None) -> tuple:
    """For each row: the RMS of got - ref, and the gap of the served token
    ``pick`` (default got's argmax) under ref's best, both over the row's
    standard deviation of ref."""
    sd = ref.std(-1)
    err = (got - ref).square().mean(-1).sqrt() / sd
    pick = got.argmax(-1) if pick is None else pick
    gap = (ref.max(-1).values - ref.gather(-1, pick[:, None])[:, 0]) / sd
    return err.cpu().numpy(), gap.cpu().numpy()


def row_errors(got: dict, ref: dict, qs):
    """For each row of two K/V caches ``{"k", "v"}`` of (B, S, K, hd): the
    quantiles ``qs`` of ||got - ref|| / ||ref|| over the row's (position,
    head) vectors of K and V, as (B, len(qs))."""
    import torch
    e = torch.cat([vector_errors(got[n], ref[n]).flatten(1)
                   for n in ("k", "v")], 1)
    q = torch.tensor(qs, dtype=e.dtype, device=e.device)
    return torch.quantile(e, q, dim=1).T.cpu().numpy()


def vector_errors(got, ref):
    """||got - ref|| / ||ref|| of every (row, position, head) vector of
    two (B, S, K, hd) tensors, as (B, S, K)."""
    got, ref = got.float(), ref.float()
    return (got - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)
