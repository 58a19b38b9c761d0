"""One-token GQA attention over a ring KV cache (the decode step): the
wrapper of the CUDA kernel ``csrc/decode_attention.cu`` and its plain
version.  Replaces the TPU kernel ``decode_attention_bk``
(``repro/kernels/decode_attention.py:66``, wrapper
``repro/kernels/ops.py:187``).

Layouts are the JAX package's: q ``(B, 1, H, hd)``, the caches
``(B, W, K, hd)`` with ``H`` a multiple of ``K``, ``slot_pos (W,)`` int32
(the absolute position held by each slot, negative for a slot never
written) and ``pos`` the current position, a 0-d int32 tensor.  A slot
counts if ``0 <= slot_pos <= pos`` and, with a window,
``pos - slot_pos < window``.

A wrapper takes the plain PyTorch version only for a tensor on the CPU.
For a CUDA tensor it launches its kernel on the current stream or raises;
it never falls back.  ``launch_counts`` counts the wrapper's launches, so
a run can show that its decode steps went through the kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.hier_aggregate import NUM_SMS

NEG_INF = -2.0e38
MAX_HEAD_DIM = 256
MAX_GROUP = 32                 # query heads per KV head: 4 warps x 8 rows
TILE = 32                      # slots per tile, as in csrc/decode_attention.cu
#: The slots are split into runs of tiles for about this many blocks per SM
#: (as ``hier_aggregate.BLOCKS_PER_SM`` for ``segment_sum``).
BLOCKS_PER_SM = 4
MAX_GRID_Y = 65_535

launch_counts = {"decode_attention": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I64] * 17 + [_INT, _INT, _P]


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def valid_slots(slot_pos, pos, window: int = 0):
    """(W,) bool: the ring slots that the token at ``pos`` attends to."""
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window > 0:
        valid &= (pos - slot_pos) < window
    return valid


def decode_attention_plain(q, k_cache, v_cache, slot_pos, pos, *,
                           window: int = 0):
    """Plain PyTorch version (``ref.py::decode_attention_ref``): fp32 scores
    over all W slots, the slots that do not count at the finite
    ``NEG_INF``, one softmax.  Returns q's dtype."""
    B, _, H, hd = q.shape
    W, K = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, K, H // K, hd).float()
    s = torch.einsum("bkgh,bwkh->bkgw", qg, k_cache.float()) / math.sqrt(hd)
    s = s.masked_fill(~valid_slots(slot_pos, pos, window), NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgw,bwkh->bkgh", p, v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


def decode_splits(bk: int, w: int):
    """``(splits, tiles per split)`` that the kernel cuts the ``w`` slots
    into: about ``BLOCKS_PER_SM`` blocks per SM over the ``bk`` (batch, KV
    head) pairs, at least one 32-slot tile per split."""
    tiles = -(-w // TILE)
    want = max(1, min(-(-BLOCKS_PER_SM * NUM_SMS // bk), tiles))
    per = -(-tiles // want)
    return -(-tiles // per), per


def _check(q, k_cache, v_cache, slot_pos, pos):
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4:
        raise ValueError("q must be (B, 1, H, hd) and the caches "
                         "(B, W, K, hd)")
    B, _, H, hd = q.shape
    W, K = k_cache.shape[1], k_cache.shape[2]
    if v_cache.shape != k_cache.shape or k_cache.shape[0] != B or \
            k_cache.shape[3] != hd:
        raise ValueError(f"caches {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if K == 0 or H % K:
        raise ValueError(f"H = {H} is not a multiple of K = {K}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"q and the caches must all be float32 or all "
                        f"bfloat16, got {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    if tuple(slot_pos.shape) != (W,) or slot_pos.dtype != torch.int32:
        raise ValueError(f"slot_pos must be ({W},) int32, got "
                         f"{tuple(slot_pos.shape)} {slot_pos.dtype}")
    if pos.dim() != 0 or pos.dtype != torch.int32:
        raise ValueError(f"pos must be a 0-d int32 tensor, got "
                         f"{tuple(pos.shape)} {pos.dtype}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("slot_pos", slot_pos), ("pos", pos)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def decode_attention(q, k_cache, v_cache, slot_pos, pos, *, window: int = 0):
    """One-token GQA ring-cache attention.  q: (B, 1, H, hd), caches
    (B, W, K, hd), fp32 or bf16; slot_pos (W,) int32; pos a 0-d int32
    tensor -> (B, 1, H, hd) of q's dtype.  On the card ``pos`` and
    ``slot_pos`` are read in device memory (no host sync) and q and the
    caches in place through their strides: the last dimension contiguous,
    hd a multiple of 4 and at most 256, the other strides multiples of 4,
    at most ``MAX_GROUP`` query heads per KV head."""
    _check(q, k_cache, v_cache, slot_pos, pos)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, slot_pos, pos,
                                      window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, _, H, hd = q.shape
    W, K = k_cache.shape[1], k_cache.shape[2]
    g = H // K
    if hd % 4 or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be a multiple of 4 in [4, "
                         f"{MAX_HEAD_DIM}], got {hd}")
    if g > MAX_GROUP:
        raise ValueError(f"{g} query heads per KV head > {MAX_GROUP}")
    if B * K > MAX_GRID_Y:
        raise ValueError(f"B * K = {B * K} > {MAX_GRID_Y}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.stride(3) != 1 or any(s % 4 for s in t.stride()[:3]) or \
                t.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous last dimension, "
                             f"strides that are multiples of 4 and a "
                             f"16-byte aligned start; got strides "
                             f"{t.stride()}")
    out = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if W == 0:
        raise ValueError("attention over an empty cache of 0 slots")
    splits, per = decode_splits(B * K, W)
    ws = torch.empty(splits * B * H * (hd + 2), dtype=torch.float32,
                     device=q.device)
    err = build.load("decode_attention", _ARGTYPES)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        slot_pos.data_ptr(), pos.data_ptr(), out.data_ptr(), ws.data_ptr(),
        B, W, H, K, hd, q.stride(0), q.stride(2), *k_cache.stride()[:3],
        *v_cache.stride()[:3], slot_pos.stride(0), int(window), splits, per,
        int(q.dtype == torch.bfloat16), q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    launch_counts["decode_attention"] += 1
    return out
