"""GQA attention: full-sequence self attention (train / prefill), decode
with a ring KV cache, and the encoder-decoder's cross attention.  Ported
from the JAX package's ``repro/models/attention.py``.

Three implementations of the score/softmax/value contraction,
full-sequence (train / prefill) and decode (one query over the ring
cache):
  * ``kernel``    — ``kernels.flash_attention`` and
                    ``kernels.decode_attention``: the CUDA kernels on the
                    card, their plain versions on the CPU (the default).
                    The kernels have no backward: on the card they refuse
                    inputs that require grad;
  * ``xla_flash`` — the reference's training route: blocked online-softmax
                    attention in plain PyTorch over key blocks of 1,024
                    (``xla_flash_attention``), differentiable by autograd
                    and ``torch.func``; decode takes the reference
                    decode's own formula;
  * ``naive``     — dense scores from positions, and the reference decode's
                    own formula; the oracle.
``chunked`` (the model's two-level-scan route) attends as ``xla_flash``.
Supports causal, sliding-window and bidirectional masking, GQA head
groups, partial RoPE and qk-norm.  Cross attention takes no kernel under
any impl, as in the reference: the dense formula for one query row,
``xla_flash_attention`` for more.

Products of two dtypes compute in the promoted one (``layers.einsum``), as
``jnp`` does; a decode cache holds the state dtype, and the kernel route
casts q to it (the kernels take one dtype).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.layers import (Spec, apply_rope, einsum, rms_norm,
                                       rope_freqs)

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
    scores = einsum("bqkgh,bskh->bkgqs", qg, k).float()
    scores = scores * (1.0 / math.sqrt(hd))
    m = _mask(q_pos, k_pos, causal, window)   # (Sq, Sk)
    scores = scores.masked_fill(~m, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)
    return out.reshape(B, Sq, H, hd)


def xla_flash_attention(q, k, v, q_pos, k_pos, causal=True, window=0,
                        block=1024):
    """Blocked online-softmax attention over key blocks of ``block``.

    q: (B,Sq,H,hd); k,v: (B,Sk,K,hd); positions int32 (Sq,)/(Sk,).
    Returns (B,Sq,H,hd).  Every block is visited (masking only), as in the
    reference's ``lax.scan``; no tensor is written in place, so autograd
    and ``torch.func`` transforms go through.  The last block holds the
    ``Sk % block`` keys left, where the reference pads k and v with zeros
    at position -1e9: its causal and bidirectional masks let a query see
    those pads, so it differs from dense attention when ``Sk > block`` is
    not a multiple of ``block`` (never at the training path's S <= 1,024
    or multiples of it).
    """
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    g = H // K
    blk = min(block, Sk)
    qg = (q.reshape(B, Sq, K, g, hd) * (1.0 / math.sqrt(hd))).to(q.dtype)
    m_i = torch.full((B, K, g, Sq), NEG_INF, dtype=torch.float32,
                     device=q.device)
    l_i = torch.zeros((B, K, g, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, g, Sq, hd), dtype=torch.float32,
                      device=q.device)
    for s0 in range(0, Sk, blk):
        kb, vb = k[:, s0:s0 + blk], v[:, s0:s0 + blk]
        s = einsum("bqkgh,bskh->bkgqs", qg, kb).float()
        msk = _mask(q_pos, k_pos[s0:s0 + blk], causal, window)  # (Sq, blk)
        s = s.masked_fill(~msk, NEG_INF)
        m_new = torch.maximum(m_i, s.amax(-1))
        alpha = torch.exp(m_i - m_new)
        p = torch.exp(s - m_new[..., None])
        l_i = l_i * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bskh->bkgqh", p.to(vb.dtype), vb).float()
        m_i = m_new
    out = acc / torch.clamp_min(l_i, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def _project_qkv(cfg, p, x, positions, inv_freqs):
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    k = einsum("bsd,dhk->bshk", x, p["wk"])
    v = einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, inv_freqs)
    k = apply_rope(k, positions, inv_freqs)
    return q, k, v


def _attend(q, k, v, positions, causal, window, impl):
    if impl == "kernel":
        return fa.flash_attention(q, k, v, causal=causal, window=window)
    if impl in ("xla_flash", "chunked"):
        return xla_flash_attention(q, k, v, positions, positions, causal,
                                   window)
    if impl == "naive":
        return naive_attention(q, k, v, positions, positions, causal, window)
    raise ValueError(f"impl must be 'kernel', 'xla_flash', 'naive' or "
                     f"'chunked', got {impl!r}")


def self_attention(cfg, p, x, *, causal=True, window=0, impl="kernel"):
    """Full-sequence self attention (train / prefill)."""
    S = x.shape[1]
    inv_freqs = rope_freqs(cfg, cfg.resolved_head_dim, x.device)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions, inv_freqs)
    o = _attend(q, k, v, positions, causal, window, impl)
    return einsum("bshk,hkd->bsd", o, p["wo"])


def cross_attention_specs(cfg):
    return attention_specs(cfg)


def cross_attention(cfg, p, x, kv_k, kv_v, impl="xla_flash"):
    """Decoder cross attention against precomputed encoder K/V
    (B, Se, K, hd), bidirectional.  No kernel under any impl, as in the
    reference: the dense formula (``naive_attention``) for one query row
    or ``impl="naive"``, else ``xla_flash_attention``."""
    Sq = x.shape[1]
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    qp = torch.arange(Sq, dtype=torch.int32, device=x.device)
    kp = torch.arange(kv_k.shape[1], dtype=torch.int32, device=x.device)
    if impl == "naive" or Sq == 1:
        o = naive_attention(q, kv_k, kv_v, qp, kp, causal=False)
    else:
        o = xla_flash_attention(q, kv_k, kv_v, qp, kp, causal=False)
    return einsum("bshk,hkd->bsd", o, p["wo"])


def encode_kv(cfg, p, enc_out):
    """Cross-attention K/V of the encoder's output, (B, Se, K, hd) each."""
    return (einsum("bsd,dhk->bshk", enc_out, p["wk"]),
            einsum("bsd,dhk->bshk", enc_out, p["wv"]))


# --------------------------------------------------------------------------
# Decode path: ring-buffer KV cache, one token per call
# --------------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, W: int, device=None,
                  dtype=torch.float32):
    """Ring cache dict of ``W`` slots (slot t % W holds token t), k and v
    of ``dtype``.  ``pos`` is a 0-d int32 tensor on the cache's device, so
    decode steps never wait on the host."""
    hd = cfg.resolved_head_dim
    shape = (batch, W, cfg.num_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "slot_pos": torch.full((W,), EMPTY_SLOT, dtype=torch.int32,
                               device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def decode_self_attention(cfg, p, x, cache, *, window=0, impl="kernel",
                          in_place=False):
    """x: (B,1,D).  Insert token at cache['pos'], attend over valid slots.
    Returns a new cache; the old one is left as it was, unless
    ``in_place``: then the token is written into ``cache``'s own k, v and
    slot_pos (a copy that the caller made, as the scanned stack does)."""
    B = x.shape[0]
    W = cache["k"].shape[1]
    hd = cfg.resolved_head_dim
    inv_freqs = rope_freqs(cfg, hd, x.device)
    pos = cache["pos"]
    positions = pos.reshape(1)
    q, k, v = _project_qkv(cfg, p, x, positions, inv_freqs)
    slot = torch.remainder(pos, W).reshape(1).long()
    write = torch.Tensor.index_copy_ if in_place else torch.Tensor.index_copy
    new_k = write(cache["k"], 1, slot, k.to(cache["k"].dtype))
    new_v = write(cache["v"], 1, slot, v.to(cache["v"].dtype))
    new_slot_pos = write(cache["slot_pos"], 0, slot, positions)

    if impl == "kernel":
        o = da.decode_attention(q.to(new_k.dtype), new_k, new_v,
                                new_slot_pos, pos, window=window)
    elif impl in ("naive", "xla_flash", "chunked"):
        H = cfg.num_heads
        K = cfg.num_kv_heads
        g = H // K
        qg = q.reshape(B, 1, K, g, hd) * (1.0 / math.sqrt(hd))
        s = einsum("bqkgh,bskh->bkgqs", qg, new_k).float()
        # empty slots hold slot_pos = -1e9 ("never written") — exclude them
        valid = (new_slot_pos >= 0) & (new_slot_pos <= pos)
        if window > 0:
            valid &= (pos - new_slot_pos) < window
        s = s.masked_fill(~valid, NEG_INF)
        pr = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskh->bqkgh", pr.to(new_v.dtype),
                         new_v).reshape(B, 1, H, hd)
    else:
        raise ValueError(f"impl must be 'kernel', 'xla_flash', 'naive' or "
                         f"'chunked', got {impl!r}")
    out = einsum("bshk,hkd->bsd", o.to(x.dtype), p["wo"])
    new_cache = {"k": new_k, "v": new_v, "slot_pos": new_slot_pos,
                 "pos": pos + 1}
    return out, new_cache


def self_attention_prefill(cfg, p, x, *, causal=True, window=0,
                           impl="kernel", cache_len=None,
                           dtype=torch.float32):
    """Full-sequence self-attention that ALSO returns the ring KV cache
    (k and v of ``dtype``) positioned for decode continuation (slot t%W
    holds token t)."""
    B, S, _ = x.shape
    inv_freqs = rope_freqs(cfg, cfg.resolved_head_dim, x.device)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions, inv_freqs)
    o = _attend(q, k, v, positions, causal, window, impl)
    out = einsum("bshk,hkd->bsd", o, p["wo"])

    W = min(window, cache_len or S) if window > 0 else (cache_len or S)
    keep = min(W, S)
    kept_pos = positions[S - keep:]
    slots = torch.remainder(kept_pos, W).long()
    cache = init_kv_cache(cfg, B, W, device=x.device, dtype=dtype)
    cache["k"][:, slots] = k[:, S - keep:].to(dtype)
    cache["v"][:, slots] = v[:, S - keep:].to(dtype)
    cache["slot_pos"][slots] = kept_pos
    cache["pos"].fill_(S)
    return out, cache
