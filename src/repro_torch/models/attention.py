"""GQA self-attention: full-sequence (train / prefill) and decode with a
ring KV cache.  Ported from the JAX package's ``repro/models/attention.py``.

Two implementations of the full-sequence score/softmax/value contraction:
  * ``kernel`` — ``kernels.flash_attention``: the CUDA kernel on the card,
                 its plain version on the CPU (the default);
  * ``naive``  — full S x S scores from positions; the oracle.
Decode attention (one query over the ring cache) is plain torch, as in the
reference.  Supports causal, sliding-window and bidirectional masking, GQA
head groups, partial RoPE and qk-norm.  Cross attention (encoder-decoder)
is not ported yet (ROADMAP Queue 1 item 14).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.models.layers import Spec, apply_rope, rms_norm, rope_freqs

NEG_INF = -2.0e38
EMPTY_SLOT = -(10 ** 9)          # slot_pos of a ring slot never written


def attention_specs(cfg, d: Optional[int] = None):
    d = d or cfg.d_model
    hd = cfg.resolved_head_dim
    s = {
        "wq": Spec((d, cfg.num_heads, hd), ("embed", "heads", "head_dim")),
        "wk": Spec((d, cfg.num_kv_heads, hd), ("embed", "kv_heads", "head_dim")),
        "wv": Spec((d, cfg.num_kv_heads, hd), ("embed", "kv_heads", "head_dim")),
        "wo": Spec((cfg.num_heads, hd, d), ("heads", "head_dim", "embed"),
                   fan_in=cfg.num_heads * hd),
    }
    if cfg.qk_norm:
        s["q_norm"] = Spec((hd,), ("head_dim",), "ones")
        s["k_norm"] = Spec((hd,), ("head_dim",), "ones")
    return s


def _mask(q_pos, k_pos, causal: bool, window: int):
    """(..., Sq, Sk) bool mask; True = attend."""
    d = q_pos[..., :, None] - k_pos[..., None, :]
    m = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        m &= d >= 0
    if window > 0:
        m &= d < window
    return m


def naive_attention(q, k, v, q_pos, k_pos, causal=True, window=0):
    """q: (B,Sq,H,hd)  k,v: (B,Sk,K,hd).  Oracle implementation."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    g = H // K
    qg = q.reshape(B, Sq, K, g, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float()
    scores = scores * (1.0 / math.sqrt(hd))
    m = _mask(q_pos, k_pos, causal, window)   # (Sq, Sk)
    scores = scores.masked_fill(~m, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)
    return out.reshape(B, Sq, H, hd)


def _project_qkv(cfg, p, x, positions, inv_freqs):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, inv_freqs)
    k = apply_rope(k, positions, inv_freqs)
    return q, k, v


def _attend(q, k, v, positions, causal, window, impl):
    if impl == "kernel":
        return fa.flash_attention(q, k, v, causal=causal, window=window)
    if impl == "naive":
        return naive_attention(q, k, v, positions, positions, causal, window)
    raise ValueError(f"impl must be 'kernel' or 'naive', got {impl!r}")


def self_attention(cfg, p, x, *, causal=True, window=0, impl="kernel"):
    """Full-sequence self attention (train / prefill)."""
    S = x.shape[1]
    inv_freqs = rope_freqs(cfg, cfg.resolved_head_dim, x.device)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions, inv_freqs)
    o = _attend(q, k, v, positions, causal, window, impl)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


# --------------------------------------------------------------------------
# Decode path: ring-buffer KV cache, one token per call
# --------------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, W: int, device=None):
    """Ring cache dict of ``W`` slots (slot t % W holds token t).  ``pos``
    is a 0-d int32 tensor on the cache's device, so decode steps never
    wait on the host."""
    hd = cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, W, cfg.num_kv_heads, hd), device=device),
        "v": torch.zeros((batch, W, cfg.num_kv_heads, hd), device=device),
        "slot_pos": torch.full((W,), EMPTY_SLOT, dtype=torch.int32,
                               device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def decode_self_attention(cfg, p, x, cache, *, window=0):
    """x: (B,1,D).  Insert token at cache['pos'], attend over valid slots.
    Returns a new cache; the old one is left as it was."""
    B = x.shape[0]
    W = cache["k"].shape[1]
    hd = cfg.resolved_head_dim
    inv_freqs = rope_freqs(cfg, hd, x.device)
    pos = cache["pos"]
    positions = pos.reshape(1)
    q, k, v = _project_qkv(cfg, p, x, positions, inv_freqs)
    slot = torch.remainder(pos, W).reshape(1).long()
    new_k = cache["k"].index_copy(1, slot, k)
    new_v = cache["v"].index_copy(1, slot, v)
    new_slot_pos = cache["slot_pos"].index_copy(0, slot, positions)

    H = cfg.num_heads
    K = cfg.num_kv_heads
    g = H // K
    qg = q.reshape(B, 1, K, g, hd) * (1.0 / math.sqrt(hd))
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, new_k).float()
    # empty slots hold slot_pos = -1e9 ("never written") — exclude them
    valid = (new_slot_pos >= 0) & (new_slot_pos <= pos)
    if window > 0:
        valid &= (pos - new_slot_pos) < window
    s = s.masked_fill(~valid, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", pr, new_v).reshape(B, 1, H, hd)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    new_cache = {"k": new_k, "v": new_v, "slot_pos": new_slot_pos,
                 "pos": pos + 1}
    return out, new_cache


def self_attention_prefill(cfg, p, x, *, causal=True, window=0,
                           impl="kernel", cache_len=None):
    """Full-sequence self-attention that ALSO returns the ring KV cache
    positioned for decode continuation (slot t%W holds token t)."""
    B, S, _ = x.shape
    inv_freqs = rope_freqs(cfg, cfg.resolved_head_dim, x.device)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions, inv_freqs)
    o = _attend(q, k, v, positions, causal, window, impl)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])

    W = min(window, cache_len or S) if window > 0 else (cache_len or S)
    keep = min(W, S)
    kept_pos = positions[S - keep:]
    slots = torch.remainder(kept_pos, W).long()
    cache = init_kv_cache(cfg, B, W, device=x.device)
    cache["k"][:, slots] = k[:, S - keep:]
    cache["v"][:, slots] = v[:, S - keep:]
    cache["slot_pos"][slots] = kept_pos
    cache["pos"].fill_(S)
    return out, cache
