"""Recurrent blocks, ported from the JAX package's
``repro/models/recurrent.py``: the RG-LRU block (RecurrentGemma/Griffin,
arXiv:2402.19427) and the xLSTM cells mLSTM and sLSTM (arXiv:2405.04517).

The RG-LRU's prefill runs its linear recurrence through
``kernels.rglru_scan`` (the CUDA kernel on the card, its plain version on
the CPU) or, with ``impl="naive"`` or ``"xla_flash"`` (the training route,
as the reference maps ``xla_flash`` to its associative scan), through the
plain version directly; ``impl="chunked"`` takes the reference's
two-level ``rglru_scan_chunked``.  The xLSTM cells reach no kernel: their
scans are python loops over time (the reference's ``lax.scan``), or, for
the mLSTM with ``impl="chunked"``, over chunks of 128 steps in the
chunkwise-parallel form (``apply_mlstm_chunked``).  Decode is a
single-step state update.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import rglru_scan as scan
from repro_torch.models.layers import Spec, act_fn, einsum, matmul

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
    r = torch.sigmoid(matmul(xi, p["w_a"]) + p["b_a"])
    i = torch.sigmoid(matmul(xi, p["w_x"]) + p["b_x"])
    log_a = -_RGLRU_C * F.softplus(p["lam"]) * r        # a = exp(log_a)
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp_min(1.0 - a.square(), 1e-12)) * (i * xi)
    return a, gated_x


def rglru_scan_chunked(a, b, chunk: int = 512):
    """The reference's two-level blocked linear recurrence: the parallel
    scan within chunks of ``chunk`` steps, a sequential scan across the
    chunks' carries,

        h[c,t] = h_within[c,t] + P[c,t] * carry[c-1],
        carry[c] = a_prod[c] * carry[c-1] + h_within[c,last].

    a, b: (B, S, D) -> h (B, S, D) fp32."""
    B, S, D = a.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        b = F.pad(b, (0, 0, 0, pad))
    C = a.shape[1] // chunk
    a = a.float().reshape(B, C, chunk, D)
    # within each chunk: P the cumulative a-product, h from a zero state
    P = torch.cumprod(a, 2)
    h_within = scan.rglru_scan_plain(
        a.reshape(B * C, chunk, D),
        b.reshape(B * C, chunk, D)).reshape(B, C, chunk, D)
    carry = torch.zeros((B, D), dtype=h_within.dtype, device=a.device)
    entry = []                          # the state entering each chunk
    for c in range(C):
        entry.append(carry)
        carry = P[:, c, -1] * carry + h_within[:, c, -1]
    h = h_within + P * torch.stack(entry, 1)[:, :, None, :]
    return h.reshape(B, C * chunk, D)[:, :S]


def apply_rglru(cfg, p, x, impl: str = "kernel", return_state: bool = False):
    """Full-sequence RG-LRU block.  x: (B,S,D) -> (B,S,D).

    ``impl="kernel"`` runs the scan through ``kernels.rglru_scan``;
    ``"naive"`` and ``"xla_flash"`` through its plain version,
    ``"chunked"`` through ``rglru_scan_chunked``.
    ``return_state=True`` also returns the decode continuation state
    {"h": final hidden (B,D) fp32, "conv": conv history (B,W-1,D)}.
    """
    gate = act_fn("gelu")(matmul(x, p["w_gate_branch"]))
    main = matmul(x, p["w_main"])
    xi, conv_state = _causal_depthwise_conv(main, p["conv_w"], p["conv_b"])
    a, bb = _rglru_gates(p, xi.float())
    if impl == "kernel":
        h = scan.rglru_scan(a, bb)
    elif impl in ("naive", "xla_flash"):
        h = scan.rglru_scan_plain(a, bb)
    elif impl == "chunked":
        h = rglru_scan_chunked(a, bb)
    else:
        raise ValueError(f"impl must be 'kernel', 'xla_flash', 'naive' or "
                         f"'chunked', got {impl!r}")
    y = matmul(h.to(x.dtype) * gate, p["w_out"])
    if return_state:
        # clones: views would keep the whole (B, S, D) h and conv input alive
        return y, {"h": h[:, -1].clone(), "conv": conv_state.clone()}
    return y


def rglru_init_state(cfg, batch: int, device=None, dtype=torch.float32):
    """{"h": fp32 (B, D), "conv": (B, W-1, D) of ``dtype``}."""
    d, w = cfg.d_model, cfg.rglru_conv_width
    return {
        "h": torch.zeros((batch, d), device=device),
        "conv": torch.zeros((batch, w - 1, d), dtype=dtype, device=device),
    }


def rglru_state_axes():
    return {"h": ("batch", "act_embed"), "conv": ("batch", None, "act_embed")}


def rglru_decode_step(cfg, p, x, state):
    """x: (B,1,D) one token."""
    gate = act_fn("gelu")(matmul(x, p["w_gate_branch"]))
    main = matmul(x, p["w_main"])
    xi, new_conv = _causal_depthwise_conv(main, p["conv_w"], p["conv_b"],
                                          state["conv"])
    a, bb = _rglru_gates(p, xi[:, 0].float())
    h = a * state["h"] + bb
    y = matmul(h[:, None].to(x.dtype) * gate, p["w_out"])
    return y, {"h": h, "conv": new_conv}


# ==========================================================================
# xLSTM  [arXiv:2405.04517]
# ==========================================================================

def mlstm_specs(cfg):
    d, H = cfg.d_model, cfg.num_heads
    hd = d // H
    return {
        "w_qkv": Spec((d, 3, H, hd), ("embed", None, "heads", "head_dim")),
        "w_if": Spec((d, 2, H), ("embed", None, "heads")),   # ĩ, f̃ pre-acts
        "b_if": Spec((2, H), (None, "heads"), "zeros"),
        "w_gate": Spec((d, d), ("embed", "mlp")),
        "w_out": Spec((d, d), ("mlp", "embed")),
    }


def _mlstm_cell(q, k, v, it, ft, state):
    """One step.  q,k,v: (B,H,hd); it,ft: (B,H); state: dict(C,n,m)."""
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(ft + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(ft + m - m_new)
    C_new = (f_p[..., None, None] * C
             + i_p[..., None, None] * (v[..., :, None] * k[..., None, :]))
    n_new = f_p[..., None] * n + i_p[..., None] * k
    denom = torch.clamp_min(torch.abs(torch.sum(n_new * q, -1)), 1.0)
    h = torch.einsum("bhvk,bhk->bhv", C_new, q) / denom[..., None]
    return h, {"C": C_new, "n": n_new, "m": m_new}


def mlstm_init_state(cfg, batch: int, device=None):
    H = cfg.num_heads
    hd = cfg.d_model // H
    return {
        "C": torch.zeros((batch, H, hd, hd), device=device),
        "n": torch.zeros((batch, H, hd), device=device),
        "m": torch.full((batch, H), -1e30, device=device),
    }


def mlstm_state_axes():
    return {"C": ("batch", "heads", None, None),
            "n": ("batch", "heads", None),
            "m": ("batch", "heads")}


def _mlstm_preact(cfg, p, x):
    d = x.shape[-1]
    hd = d // cfg.num_heads
    qkv = einsum("bsd,dthk->tbshk", x, p["w_qkv"]).float()
    q, k, v = qkv[0], qkv[1] / math.sqrt(hd), qkv[2]
    if_ = (einsum("bsd,dth->tbsh", x, p["w_if"]).float()
           + p["b_if"].float()[:, None, None])
    return q, k, v, if_[0], if_[1]


def apply_mlstm(cfg, p, x, state=None):
    """Full-sequence mLSTM block, a python loop over time.  x: (B,S,d) ->
    (y (B,S,d), final state)."""
    B, S, d = x.shape
    q, k, v, it, ft = _mlstm_preact(cfg, p, x)
    ft = -F.softplus(-ft)   # log σ(f̃): forget gate in log space
    st = state or mlstm_init_state(cfg, B, x.device)
    hs = []
    for t in range(S):
        h, st = _mlstm_cell(q[:, t], k[:, t], v[:, t], it[:, t], ft[:, t], st)
        hs.append(h)
    h = torch.stack(hs, 1).reshape(B, S, d).to(x.dtype)
    return matmul(h * F.silu(matmul(x, p["w_gate"])), p["w_out"]), st


def apply_mlstm_chunked(cfg, p, x, state=None, chunk: int = 128):
    """Chunkwise-parallel mLSTM, the reference's form: with no
    hidden-to-gate feedback the recurrence is
    h_t = sum_{s<=t} w_{t,s} v_s (k_s . q_t) / denom with
    w_{t,s} = exp(F_t - F_s + i_s - m_t), F = cumsum(log f): L x L products
    a chunk plus a python loop over the S/L chunk carries.  Equals
    ``apply_mlstm`` (the same stabiliser m) up to float association."""
    B, S, d = x.shape
    H = cfg.num_heads
    hd = d // H
    q, k, v, it, ft = _mlstm_preact(cfg, p, x)
    ft = -F.softplus(-ft)                          # log sigma(f~)
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        # padded steps: f=1 (log 0) keeps F flat, i = -inf kills their keys
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        it = F.pad(it, (0, 0, 0, pad), value=-1e30)
        ft = F.pad(ft, (0, 0, 0, pad))
    n_chunks = q.shape[1] // L
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x.device))
    st = state or mlstm_init_state(cfg, B, x.device)
    hs = []
    for c in range(n_chunks):
        sl = slice(c * L, (c + 1) * L)
        qc, kc, vc, ic, fc = q[:, sl], k[:, sl], v[:, sl], it[:, sl], ft[:, sl]
        C_prev, n_prev, m_prev = st["C"], st["n"], st["m"]
        Fc = torch.cumsum(fc, 1)                           # (B,L,H)
        u = ic - Fc                                        # i_s - F_s
        m_local = torch.cummax(u, 1).values
        m_t = torch.maximum(Fc + m_prev[:, None], Fc + m_local)   # (B,L,H)
        # intra-chunk decay-weighted scores
        logw = Fc[:, :, None] + u[:, None, :] - m_t[:, :, None]   # (B,t,s,H)
        w = torch.where(causal[None, :, :, None], torch.exp(logw),
                        torch.zeros((), device=x.device))
        scores = torch.einsum("bthk,bshk->btsh", qc, kc)
        intra = torch.einsum("btsh,bshk->bthk", w * scores, vc)
        # inter-chunk (carry) contribution
        lam = torch.exp(Fc + m_prev[:, None] - m_t)        # (B,L,H)
        inter = torch.einsum("bthk,bhvk->bthv", qc, C_prev) * lam[..., None]
        n_t = (torch.einsum("btsh,bshk->bthk", w, kc)
               + lam[..., None] * n_prev[:, None])
        denom = torch.clamp_min(torch.abs(torch.sum(n_t * qc, -1)), 1.0)
        hs.append((intra + inter) / denom[..., None])
        # carry to chunk end
        Ftot, m_end = Fc[:, -1], m_t[:, -1]                # (B,H)
        gamma = torch.exp(Ftot + m_prev - m_end)
        wv = torch.exp(Ftot[:, None] + u - m_end[:, None])  # (B,L,H)
        st = {"C": gamma[..., None, None] * C_prev
                   + torch.einsum("bshv,bshk,bsh->bhvk", vc, kc, wv),
              "n": gamma[..., None] * n_prev
                   + torch.einsum("bshk,bsh->bhk", kc, wv),
              "m": m_end}
    h = torch.cat(hs, 1).reshape(B, n_chunks * L, d)[:, :S].to(x.dtype)
    return matmul(h * F.silu(matmul(x, p["w_gate"])), p["w_out"]), st


def mlstm_decode_step(cfg, p, x, state):
    return apply_mlstm(cfg, p, x, state)


def slstm_specs(cfg):
    d = cfg.d_model
    H = cfg.slstm_heads or cfg.num_heads
    hd = d // H
    f_ffn = int(d * 4 / 3) // 8 * 8
    return {
        "w_gates": Spec((d, 4, H, hd), ("embed", None, "heads", "head_dim")),
        "r_gates": Spec((H, hd, 4, hd), ("heads", "head_dim", None, None),
                        fan_in=hd),
        "b_gates": Spec((4, H, hd), (None, "heads", "head_dim"), "zeros"),
        "w_out": Spec((d, d), ("mlp", "embed")),
        "ffn_wi": Spec((d, f_ffn), ("embed", "mlp")),
        "ffn_wo": Spec((f_ffn, d), ("mlp", "embed")),
    }


def slstm_init_state(cfg, batch: int, device=None):
    H = cfg.slstm_heads or cfg.num_heads
    shape = (batch, H, cfg.d_model // H)
    return {"c": torch.zeros(shape, device=device),
            "n": torch.zeros(shape, device=device),
            "h": torch.zeros(shape, device=device),
            "m": torch.full(shape, -1e30, device=device)}


def slstm_state_axes():
    ax = ("batch", "heads", None)
    return {"c": ax, "n": ax, "h": ax, "m": ax}


def _slstm_cell(p, wx, state):
    """wx: (B,4,H,hd) input pre-acts; recurrent contribution added here."""
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    rec = torch.einsum("bhk,hktj->bthj", h, p["r_gates"].float())
    pre = wx + rec + p["b_gates"].float()
    zt = torch.tanh(pre[:, 0])
    it = pre[:, 1]
    ft = -F.softplus(-pre[:, 2])   # log σ
    ot = torch.sigmoid(pre[:, 3])
    m_new = torch.maximum(ft + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(ft + m - m_new)
    c_new = f_p * c + i_p * zt
    n_new = f_p * n + i_p
    h_new = ot * c_new / torch.clamp_min(n_new, 1e-6)
    return h_new, {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def apply_slstm(cfg, p, x, state=None):
    """Full-sequence sLSTM block (cell, projection and its GELU FFN), a
    python loop over time.  x: (B,S,d) -> (y (B,S,d), final state)."""
    B, S, d = x.shape
    wx = einsum("bsd,dthj->bsthj", x, p["w_gates"]).float()
    st = state or slstm_init_state(cfg, B, x.device)
    hs = []
    for t in range(S):
        h, st = _slstm_cell(p, wx[:, t], st)
        hs.append(h)
    h = torch.stack(hs, 1).reshape(B, S, d).to(x.dtype)
    y = matmul(h, p["w_out"])
    return y + matmul(act_fn("gelu")(matmul(y, p["ffn_wi"])),
                      p["ffn_wo"]), st


def slstm_decode_step(cfg, p, x, state):
    return apply_slstm(cfg, p, x, state)
