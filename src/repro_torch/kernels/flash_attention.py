"""Blocked online-softmax GQA attention with causal and sliding-window
masks: the wrapper of the CUDA kernel ``csrc/flash_attention.cu`` and its
plain version.  Replaces the TPU kernel ``flash_attention_bkh``
(``repro/kernels/flash_attention.py:89``, wrapper
``repro/kernels/ops.py:57``).

Layouts are the JAX package's: q ``(B, Sq, H, hd)``, k and v
``(B, Sk, K, hd)`` with ``H`` a multiple of ``K`` (query head ``h`` reads
KV head ``h // (H // K)``); query row ``i`` sits at position
``i + Sk - Sq``, so the sequence ends are aligned.

A wrapper takes the plain PyTorch version only for a tensor on the CPU.
For a CUDA tensor it launches its kernel on the current stream or raises;
it never falls back.  ``launch_counts`` counts the launches, so a run can
show that its attention layers went through the kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

NEG_INF = -2.0e38
MAX_HEAD_DIM = 256

launch_counts = {"flash_attention": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P] + [_I64] * 15 + [_INT, _I64, _I64, _INT, _INT,
                                              _P]


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def attention_mask(sq: int, sk: int, causal: bool, window: int, device=None):
    """(Sq, Sk) bool, True where query row i (position i + Sk - Sq) sees
    key j."""
    d = (torch.arange(sq, device=device)[:, None] + (sk - sq)
         - torch.arange(sk, device=device)[None, :])
    m = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        m &= d >= 0
    if window > 0:
        m &= d < window
    return m


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """Plain PyTorch version: dense fp32 softmax over the masked scores,
    masked entries at the finite ``NEG_INF``.  Returns q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    g = H // K
    qg = q.reshape(B, Sq, K, g, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) / math.sqrt(hd)
    m = attention_mask(Sq, Sk, causal, window, q.device)
    s = s.masked_fill(~m, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def _check(q, k, v, causal):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q must be (B, Sq, H, hd) and k, v (B, Sk, K, hd)")
    B, Sq, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"H = {H} is not a multiple of K = {k.shape[2]}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v lie on {q.device}, {k.device}, {v.device}")
    if causal and Sq > k.shape[1]:
        raise ValueError(f"causal attention with Sq = {Sq} > Sk = "
                         f"{k.shape[1]}: the first query rows see no key")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """GQA attention.  q: (B, Sq, H, hd), k, v: (B, Sk, K, hd), fp32 or
    bf16 -> (B, Sq, H, hd) of q's dtype.  On the card the operands are read
    in place through their strides: the last dimension must be contiguous,
    hd a multiple of 4 and at most 256, the other strides multiples of 4."""
    _check(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if hd % 4 or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be a multiple of 4 in [4, "
                         f"{MAX_HEAD_DIM}], got {hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % 4 for s in t.stride()[:3]) or \
                t.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous last dimension, "
                             f"strides that are multiples of 4 and a "
                             f"16-byte aligned start; got strides "
                             f"{t.stride()}")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if Sk == 0:
        raise ValueError("attention over no keys")
    err = build.load("flash_attention", _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, K, hd, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], int(causal), int(window), Sk - Sq,
        int(q.dtype == torch.bfloat16), q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launch_counts["flash_attention"] += 1
    return out
