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

On a mesh (DTensor activations, ``Model(mesh=)``) the projections run on
DTensors, and the score/softmax/value contraction of every impl, with the
decode cache's write, runs on each rank's LOCAL heads and batch rows
(``_local_heads``, through ``sharding.shard_map``): the heads shard over
'model' where they divide, the batch keeps its data sharding, everything
else is gathered.  Where the query heads divide the 'model' axis and the
KV heads do not, but the axis is a multiple of them (GQA), each rank
attends with the one KV head its query heads share.  So under
``impl="kernel"`` K5 and K7 run on every rank on its local heads.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.layers import (Spec, apply_rope, einsum, matmul,
                                       promoted, rms_norm, rope_freqs)

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


def _proj(x, w):
    """``einsum("bsd,dhk->bshk", x, w)``.  On a mesh, with the heads
    sharded, one product over the flat (heads x head_dim) dim, so each
    rank computes its own heads (DTensor's einsum would gather them);
    with the heads not sharded (8 KV heads on a 16-way 'model' axis),
    each rank's batch rows against the whole weight, so no flat dim is
    ever split unevenly (DTensor may shard it evenly but cannot then
    unflatten it)."""
    if not _is_dtensor(x):
        return einsum("bsd,dhk->bshk", x, w)
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.parallel import sharding as shd
    mesh = x.device_mesh
    if all(not (isinstance(p, Shard) and p.dim == 1) for p in w.placements):
        xpl = shd.batch_placements(x)
        rep = tuple(Replicate() for _ in xpl)
        return shd.shard_map(lambda x_, w_: einsum("bsd,dhk->bshk", x_, w_),
                             mesh, (xpl, rep), xpl)(x, w)
    return matmul(x, w.flatten(1)).unflatten(-1, tuple(w.shape[1:]))


def _out_proj(o, wo):
    """``einsum("bshk,hkd->bsd", o, wo)``, on a mesh a product over the
    flat (heads x head_dim) dim: each rank's heads' product summed over
    'model' (``sharding.row_parallel``, whose backward too is each rank's
    own heads' products), then settled (``sharding.settle``)."""
    if not _is_dtensor(o):
        return einsum("bshk,hkd->bsd", o, wo)
    from repro_torch.parallel.sharding import row_parallel
    return _settle(row_parallel(*promoted(o.flatten(2), wo.flatten(0, 1))))


def _project_qkv(cfg, p, x, positions, inv_freqs):
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, inv_freqs)
    k = apply_rope(k, positions, inv_freqs)
    return q, k, v


def _local_heads(fn, q, k, v, *rest, rest_kv=(), out_kv=0):
    """``fn(q, k, v, kv_slice, *rest_kv, *rest)`` on each rank's local
    heads (see the module's docstring): q (B, S, H, hd), k and v and the
    ``rest_kv`` tensors (B, ., K, hd) DTensors; ``rest`` replicated
    DTensors (slot positions, the position).  ``kv_slice(t)`` takes a
    local (B, ., K, hd) tensor to the KV heads of the rank's query heads.
    ``fn`` returns the attention output (B, S, H, hd), then ``out_kv``
    tensors laid out as k (a decode's new cache), then tensors laid out
    as ``rest``."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.mesh import MODEL_AXIS
    from repro_torch.parallel import sharding as shd
    mesh = q.device_mesh
    # a plain tensor (an encoder-decoder's fresh self-attention ring) is
    # the same on every rank: replicated
    k, v, *rest_kv = (shd.as_replicated(t, mesh) for t in (k, v) + tuple(
        rest_kv))
    H, K = q.shape[2], k.shape[2]
    qpl, kpl, per_kv = [], [], 1
    for j, name in enumerate(mesh.mesh_dim_names):
        n = mesh.size(j)
        if any(t.placements[j] == Shard(0) for t in (q,) + tuple(rest_kv)):
            # the batch's axes (a decode's cache keeps its own)
            qpl.append(Shard(0))
            kpl.append(Shard(0))
        elif (name == MODEL_AXIS and n > 1 and H % n == 0
              and (K % n == 0 or n % K == 0)):
            qpl.append(Shard(2))
            if K % n == 0:
                kpl.append(Shard(2))
            else:
                kpl.append(Replicate())
                per_kv = n // K
        else:
            qpl.append(Replicate())
            kpl.append(Replicate())
    rpl = tuple(Replicate() for _ in qpl)
    qpl, kpl = tuple(qpl), tuple(kpl)

    def kv_slice(t):
        if per_kv == 1:
            return t
        i = mesh.get_local_rank(MODEL_AXIS) // per_kv
        return t[:, :, i:i + 1]

    def body(q_, k_, v_, *more):
        return fn(q_, k_, v_, kv_slice, *more)

    ins = (qpl, kpl, kpl) + (kpl,) * len(rest_kv) + (rpl,) * len(rest)
    outs = (qpl,) + (kpl,) * out_kv + (rpl,) * (len(rest) if out_kv else 0)
    return shd.shard_map(body, mesh, ins, outs if len(outs) > 1 else qpl)(
        q, k, v, *rest_kv, *rest)


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


def _full_attention(q, k, v, causal, window, impl, constrain):
    """The score/softmax/value contraction of a full sequence, on the
    local heads on a mesh (after ``constrain``-ing q to its logical
    axes, as the reference does)."""
    S = q.shape[1]
    if constrain is not None:
        q = constrain(q, ("batch", "seq", "act_heads", "head_dim"))
    if not _is_dtensor(q):
        positions = torch.arange(S, dtype=torch.int32, device=q.device)
        return _attend(q, k, v, positions, causal, window, impl)

    def local(q_, k_, v_, kv_slice):
        positions = torch.arange(S, dtype=torch.int32, device=q_.device)
        return _attend(q_, kv_slice(k_), kv_slice(v_), positions, causal,
                       window, impl)
    return _local_heads(local, q, k, v)


def _is_dtensor(x) -> bool:
    from repro_torch.parallel.sharding import is_dtensor
    return is_dtensor(x)


def _settle(x):
    from repro_torch.parallel.sharding import settle
    return settle(x)


def self_attention(cfg, p, x, *, causal=True, window=0, impl="kernel",
                   constrain=None):
    """Full-sequence self attention (train / prefill)."""
    S = x.shape[1]
    inv_freqs = rope_freqs(cfg, cfg.resolved_head_dim, x.device)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions, inv_freqs)
    o = _full_attention(q, k, v, causal, window, impl, constrain)
    return _out_proj(o, p["wo"])


def cross_attention_specs(cfg):
    return attention_specs(cfg)


def cross_attention(cfg, p, x, kv_k, kv_v, impl="xla_flash"):
    """Decoder cross attention against precomputed encoder K/V
    (B, Se, K, hd), bidirectional.  No kernel under any impl, as in the
    reference: the dense formula (``naive_attention``) for one query row
    or ``impl="naive"``, else ``xla_flash_attention``."""
    Sq, Se = x.shape[1], kv_k.shape[1]
    q = _proj(x, p["wq"])

    def attend(q_, k_, v_, kv_slice=lambda t: t):
        qp = torch.arange(Sq, dtype=torch.int32, device=q_.device)
        kp = torch.arange(Se, dtype=torch.int32, device=q_.device)
        fn = (naive_attention if impl == "naive" or Sq == 1
              else xla_flash_attention)
        return fn(q_, kv_slice(k_), kv_slice(v_), qp, kp, causal=False)
    o = (_local_heads(attend, q, kv_k, kv_v) if _is_dtensor(q)
         else attend(q, kv_k, kv_v))
    return _out_proj(o, p["wo"])


def encode_kv(cfg, p, enc_out):
    """Cross-attention K/V of the encoder's output, (B, Se, K, hd) each."""
    return _proj(enc_out, p["wk"]), _proj(enc_out, p["wv"])


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
    slot_pos (a copy that the caller made, as the scanned stack does).  On
    a mesh the write and the attention run on the local heads and a new
    cache is returned (``in_place`` is not taken)."""
    hd = cfg.resolved_head_dim
    inv_freqs = rope_freqs(cfg, hd, x.device)
    pos = cache["pos"]
    positions = pos.reshape(1)
    q, k, v = _project_qkv(cfg, p, x, positions, inv_freqs)
    if _is_dtensor(q):
        def local(q_, k_, v_, kv_slice, ck, cv, slot_pos, pos_):
            return _decode_local(q_, k_, v_, ck, cv, slot_pos, pos_, window,
                                 impl, False, kv_slice)
        o, new_k, new_v, new_slot_pos, _ = _local_heads(
            local, q, k, v, cache["slot_pos"], pos,
            rest_kv=(cache["k"], cache["v"]), out_kv=2)
    else:
        o, new_k, new_v, new_slot_pos, _ = _decode_local(
            q, k, v, cache["k"], cache["v"], cache["slot_pos"], pos, window,
            impl, in_place, lambda t: t)
    out = _out_proj(o.to(x.dtype), p["wo"])
    new_cache = {"k": new_k, "v": new_v, "slot_pos": new_slot_pos,
                 "pos": pos + 1}
    return out, new_cache


def _decode_local(q, k, v, cache_k, cache_v, slot_pos, pos, window, impl,
                  in_place, kv_slice):
    """One token's cache write and attention on plain tensors: q (B,1,H,hd),
    k, v (B,1,K,hd) into the ring (B,W,K,hd); attention over the KV heads
    ``kv_slice`` keeps.  Returns (o, new_k, new_v, new_slot_pos) (and, as a
    ``_local_heads`` body, the position as it came)."""
    B, _, H, hd = q.shape
    W = cache_k.shape[1]
    positions = pos.reshape(1)
    slot = torch.remainder(pos, W).reshape(1).long()
    write = torch.Tensor.index_copy_ if in_place else torch.Tensor.index_copy
    new_k = write(cache_k, 1, slot, k.to(cache_k.dtype))
    new_v = write(cache_v, 1, slot, v.to(cache_v.dtype))
    new_slot_pos = write(slot_pos, 0, slot, positions)
    ak, av = kv_slice(new_k), kv_slice(new_v)
    if impl == "kernel":
        o = da.decode_attention(q.to(ak.dtype), ak, av, new_slot_pos, pos,
                                window=window)
    elif impl in ("naive", "xla_flash", "chunked"):
        K = ak.shape[2]
        g = H // K
        qg = q.reshape(B, 1, K, g, hd) * (1.0 / math.sqrt(hd))
        s = einsum("bqkgh,bskh->bkgqs", qg, ak).float()
        # empty slots hold slot_pos = -1e9 ("never written") — exclude them
        valid = (new_slot_pos >= 0) & (new_slot_pos <= pos)
        if window > 0:
            valid &= (pos - new_slot_pos) < window
        s = s.masked_fill(~valid, NEG_INF)
        pr = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskh->bqkgh", pr.to(av.dtype),
                         av).reshape(B, 1, H, hd)
    else:
        raise ValueError(f"impl must be 'kernel', 'xla_flash', 'naive' or "
                         f"'chunked', got {impl!r}")
    return o, new_k, new_v, new_slot_pos, pos


def self_attention_prefill(cfg, p, x, *, causal=True, window=0,
                           impl="kernel", cache_len=None,
                           dtype=torch.float32, constrain=None):
    """Full-sequence self-attention that ALSO returns the ring KV cache
    (k and v of ``dtype``) positioned for decode continuation (slot t%W
    holds token t)."""
    B, S, _ = x.shape
    inv_freqs = rope_freqs(cfg, cfg.resolved_head_dim, x.device)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions, inv_freqs)
    o = _full_attention(q, k, v, causal, window, impl, constrain)
    out = _out_proj(o, p["wo"])

    W = min(window, cache_len or S) if window > 0 else (cache_len or S)
    keep = min(W, S)
    # the last `keep` tokens, then the empty slots, rolled so that token t
    # sits in slot t % W (no write in place, so DTensors go through)
    shift = (S - keep) % W

    def roll(t, dim):
        # torch.roll as a cat of two slices (which every DTensor version
        # shards)
        if shift == 0:
            return t
        return torch.cat([t.narrow(dim, W - shift, shift),
                          t.narrow(dim, 0, W - shift)], dim)

    def ring(t):
        t = t[:, S - keep:].to(dtype)
        pad = torch.zeros_like(t[:, :1]).expand(-1, W - keep, -1, -1)
        return roll(torch.cat([t, pad], 1), 1)

    slot_pos = torch.full((W,), EMPTY_SLOT, dtype=torch.int32,
                          device=x.device)
    slot_pos[:keep] = positions[S - keep:]
    cache = {"k": ring(k), "v": ring(v),
             "slot_pos": roll(slot_pos, 0),
             "pos": torch.full((), S, dtype=torch.int32, device=x.device)}
    return out, cache
