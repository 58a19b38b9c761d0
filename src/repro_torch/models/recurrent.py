"""RG-LRU recurrent block (RecurrentGemma/Griffin, arXiv:2402.19427),
ported from the JAX package's ``repro/models/recurrent.py``.

Prefill runs the linear recurrence through ``kernels.rglru_scan`` (the
CUDA kernel on the card, its plain version on the CPU) or, with
``impl="naive"``, through the plain version directly; decode is a
single-step state update.  The xLSTM cells (``mlstm``, ``slstm``) are not
ported yet (ROADMAP Queue 1 item 14).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import rglru_scan as scan
from repro_torch.models.layers import Spec, act_fn

_RGLRU_C = 8.0


def rglru_specs(cfg):
    d = cfg.d_model
    w = cfg.rglru_conv_width
    return {
        "w_main": Spec((d, d), ("embed", "mlp")),
        "w_gate_branch": Spec((d, d), ("embed", "mlp")),
        "conv_w": Spec((w, d), ("conv", "act_embed"), fan_in=w),
        "conv_b": Spec((d,), ("act_embed",), "zeros"),
        "w_a": Spec((d, d), ("embed", "mlp")),
        "b_a": Spec((d,), ("act_embed",), "zeros"),
        "w_x": Spec((d, d), ("embed", "mlp")),
        "b_x": Spec((d,), ("act_embed",), "zeros"),
        "lam": Spec((d,), ("act_embed",), "ones"),   # Λ; a = σ(Λ)
        "w_out": Spec((d, d), ("mlp", "embed")),
    }


def _causal_depthwise_conv(x, w, b, state: Optional[torch.Tensor] = None):
    """x: (B,S,D); w: (W,D) depthwise causal.  state: (B,W-1,D) history."""
    W = w.shape[0]
    if state is None:
        hist = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    else:
        hist = state.to(x.dtype)
    xp = torch.cat([hist, x], dim=1)
    out = sum(xp[:, i: i + x.shape[1]] * w[i] for i in range(W))
    new_state = xp[:, -(W - 1):] if W > 1 else hist
    return out + b, new_state


def _rglru_gates(p, xi):
    """Per-step gate computation.  xi: (..., D) conv output."""
    r = torch.sigmoid(xi @ p["w_a"] + p["b_a"])
    i = torch.sigmoid(xi @ p["w_x"] + p["b_x"])
    log_a = -_RGLRU_C * F.softplus(p["lam"]) * r        # a = exp(log_a)
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp_min(1.0 - a.square(), 1e-12)) * (i * xi)
    return a, gated_x


def apply_rglru(cfg, p, x, impl: str = "kernel", return_state: bool = False):
    """Full-sequence RG-LRU block.  x: (B,S,D) -> (B,S,D).

    ``impl="kernel"`` runs the scan through ``kernels.rglru_scan``;
    ``"naive"`` through its plain version.  ``return_state=True`` also
    returns the decode continuation state {"h": final hidden (B,D) fp32,
    "conv": conv history (B,W-1,D)}.
    """
    gate = act_fn("gelu")(x @ p["w_gate_branch"])
    main = x @ p["w_main"]
    xi, conv_state = _causal_depthwise_conv(main, p["conv_w"], p["conv_b"])
    a, bb = _rglru_gates(p, xi.float())
    if impl == "kernel":
        h = scan.rglru_scan(a, bb)
    elif impl == "naive":
        h = scan.rglru_scan_plain(a, bb)
    else:
        raise ValueError(f"impl must be 'kernel' or 'naive', got {impl!r}")
    y = (h.to(x.dtype) * gate) @ p["w_out"]
    if return_state:
        # clones: views would keep the whole (B, S, D) h and conv input alive
        return y, {"h": h[:, -1].clone(), "conv": conv_state.clone()}
    return y


def rglru_init_state(cfg, batch: int, device=None):
    d, w = cfg.d_model, cfg.rglru_conv_width
    return {
        "h": torch.zeros((batch, d), device=device),
        "conv": torch.zeros((batch, w - 1, d), device=device),
    }


def rglru_decode_step(cfg, p, x, state):
    """x: (B,1,D) one token."""
    gate = act_fn("gelu")(x @ p["w_gate_branch"])
    main = x @ p["w_main"]
    xi, new_conv = _causal_depthwise_conv(main, p["conv_w"], p["conv_b"],
                                          state["conv"])
    a, bb = _rglru_gates(p, xi[:, 0].float())
    h = a * state["h"] + bb
    y = (h[:, None].to(x.dtype) * gate) @ p["w_out"]
    return y, {"h": h, "conv": new_conv}
