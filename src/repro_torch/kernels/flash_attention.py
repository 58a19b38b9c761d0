"""Blocked online-softmax GQA attention with causal and sliding-window
masks: the wrapper of the CUDA kernels ``csrc/flash_attention.cu`` (fp32,
CUDA cores) and ``csrc/flash_attention_bf16.cu`` (bf16, ``wgmma`` on the
tensor cores) and their plain version.  Replaces the TPU kernel ``flash_attention_bkh``
(``repro/kernels/flash_attention.py:89``, wrapper
``repro/kernels/ops.py:57``).

Layouts are the JAX package's: q ``(B, Sq, H, hd)``, k and v
``(B, Sk, K, hd)`` with ``H`` a multiple of ``K`` (query head ``h`` reads
KV head ``h // (H // K)``); query row ``i`` sits at position
``i + Sk - Sq``, so the sequence ends are aligned.

A wrapper takes the plain PyTorch version only for a tensor on the CPU.
For a CUDA tensor it launches its kernel on the current stream or raises;
it never falls back.  The kernel has no backward: on the card the wrapper
raises on inputs that require grad and under ``torch.func`` transforms
(``grad_guard``).  ``launch_counts`` (held by ``repro_torch.tracing``'s
registry) counts the launches under the kernel launched
(``flash_attention`` in fp32, ``flash_attention_bf16`` in bf16), so a run
can show that its attention layers went through the kernel; each launch
also hands its cost (``flash_attention_cost``) to the running cost walks
(``kernels.costs``) under the same name.

On the card a block serves the whole query group of one (batch, KV head):
its rows are consecutive (query position, head) pairs.  In fp32
``rows_per_warp`` a warp, and ``attention_warps`` picks its warps; in
bf16 64 a consumer warpgroup, and ``bf16_block_rows`` picks the rows.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.kernels import build, costs
from repro_torch.kernels.grad_guard import refuse_autograd
from repro_torch.launch.mesh import NUM_SMS

NEG_INF = -2.0e38
MAX_HEAD_DIM = 256
KEY_TILE = 64                  # keys per K/V tile of the kernel
#: Warps per block at most (256 threads, the kernel's launch bound).
MAX_WARPS = 8

#: Rows a block of the bf16 kernel may take: 128 (two consumer
#: warpgroups of 64; head dims up to 128), or 64, 32, 16 live rows of one.
BF16_ROWS = (128, 64, 32, 16)

launch_counts = tracing.launch_counts("flash_attention",
                                      "flash_attention_bf16")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
# both kernels' C functions: pointers, 15 sizes and strides, causal,
# window, offset, warps (fp32) or rows (bf16), device, stream
_ARGTYPES = [_P, _P, _P, _P] + [_I64] * 15 + [_INT, _I64, _I64, _INT, _INT,
                                              _P]


def head_dim_class(hd: int) -> int:
    """The kernel's instantiation for head dim ``hd``: 64, 128 or 256 (the
    smallest that holds it; the extra columns are zeros)."""
    return 64 if hd <= 64 else 128 if hd <= 128 else 256


def rows_per_warp(hd: int) -> int:
    """Query rows of a warp (row groups x rows a lane): 4 x 4 at head dims
    up to 64, 2 x 8 up to 128, 2 x 4 up to 256."""
    return {64: 16, 128: 16, 256: 8}[head_dim_class(hd)]


def attention_smem_bytes(hd: int, warps: int) -> int:
    """Shared memory of one block of ``warps`` warps, as the kernel lays it
    out: Q ``[R][HD + 4]`` (``R = rows_per_warp * warps``), a K and a V
    buffer ``[KEY_TILE][HD + 4]``, one P buffer ``[KEY_TILE][rows_per_warp
    + 4]`` per warp; fp32."""
    c, rpw = head_dim_class(hd), rows_per_warp(hd)
    return 4 * (rpw * warps * (c + 4) + 2 * KEY_TILE * (c + 4)
                + warps * KEY_TILE * (rpw + 4))


def attention_blocks(batch: int, sq: int, heads: int, kv_heads: int,
                     hd: int, warps: int) -> int:
    """Blocks of one launch: ``ceil(Sq * g / R)`` row tiles per (batch, KV
    head)."""
    rows = rows_per_warp(hd) * warps
    return -(-sq * (heads // kv_heads) // rows) * batch * kv_heads


def min_warps(hd: int) -> int:
    """The fewest warps a block takes: its threads must be a multiple of
    the ``HD / 4`` float4s of a K/V row (2 warps at head dims above 128)."""
    return 2 if head_dim_class(hd) == 256 else 1


def attention_warps(batch: int, sq: int, heads: int, kv_heads: int,
                    hd: int) -> int:
    """Warps per block: the most, up to ``MAX_WARPS``, whose launch still
    has ``NUM_SMS`` blocks; ``min_warps`` when none has.  Fewer warps mean
    fewer rows a block, so short prompts still spread over the card."""
    w = MAX_WARPS
    while w > min_warps(hd) and attention_blocks(batch, sq, heads, kv_heads,
                                                 hd, w) < NUM_SMS:
        w //= 2
    return w


def bf16_stages(hd: int) -> int:
    """K/V tiles in the bf16 kernel's ring: 4, 3, 2 at head-dim classes
    64, 128, 256."""
    return {64: 4, 128: 3, 256: 2}[head_dim_class(hd)]


def bf16_smem_bytes(hd: int, rows: int) -> int:
    """Shared memory of one bf16 block of ``rows`` rows, as the kernel lays
    it out: a Q tile of 64 rows a consumer warpgroup (two at 128 rows),
    ``bf16_stages`` K and V tiles of ``KEY_TILE`` keys, all ``HD`` bf16
    wide, three mbarriers a stage, and 1,024 bytes of alignment slack."""
    c, stages = head_dim_class(hd), bf16_stages(hd)
    tile = 64 * c * 2
    return 1024 + (2 if rows == 128 else 1) * tile + 2 * stages * tile \
        + 3 * stages * 8


def bf16_blocks(batch: int, sq: int, heads: int, kv_heads: int,
                rows: int) -> int:
    """Blocks of one bf16 launch: ``ceil(Sq * g / rows)`` row tiles per
    (batch, KV head)."""
    return -(-sq * (heads // kv_heads) // rows) * batch * kv_heads


def bf16_max_rows(hd: int) -> int:
    """The most rows a bf16 block takes: 128 up to head dim 128; 64 above,
    where a consumer's O fragment (128 fp32 registers a thread) needs
    more registers than a two-consumer block can give it."""
    return 64 if head_dim_class(hd) == 256 else 128


def bf16_block_rows(batch: int, sq: int, heads: int, kv_heads: int,
                    hd: int) -> int:
    """Rows a bf16 block: the most of ``BF16_ROWS`` (at most
    ``bf16_max_rows``) whose launch still has ``NUM_SMS`` blocks; the
    fewest when none has.  Below 64 a block's one consumer warpgroup
    computes 64 rows and keeps that many, so short prompts still spread
    over the card."""
    for rows in BF16_ROWS:
        if rows <= bf16_max_rows(hd) and bf16_blocks(
                batch, sq, heads, kv_heads, rows) >= NUM_SMS:
            return rows
    return BF16_ROWS[-1]


def check_bf16_operands(q, k, v) -> None:
    """The bf16 kernel's operand contract, which its TMA tensor maps and
    16-byte Q loads need: hd a multiple of 8 in [8, ``MAX_HEAD_DIM``]; for
    each of q, k, v a contiguous last dimension, (batch, sequence, head)
    strides that are multiples of 8 elements (a dimension of size 1 may
    have any stride) and a 16-byte aligned start.  Raises ``ValueError``.
    ``_project_qkv``'s outputs (contiguous, or views of a fused
    (B, S, H + 2K, hd) projection) meet it at every config's head dim."""
    hd = q.shape[-1]
    if hd % 8 or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"bf16 attention needs a head_dim that is a "
                         f"multiple of 8 in [8, {MAX_HEAD_DIM}], got {hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 and t.shape[3] > 1 or t.data_ptr() % 16 or any(
                st % 8 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1):
            raise ValueError(f"bf16 attention: {name} needs a contiguous "
                             f"last dimension, strides that are multiples "
                             f"of 8 and a 16-byte aligned start; got "
                             f"strides {t.stride()} at byte "
                             f"{t.data_ptr() % 16} of 16")


def _tma_strides(t) -> tuple:
    """t's (batch, sequence, head) strides, a size-1 dimension's replaced by
    the stride the dimension inside it would give it (its value never
    counts), so that every stride the tensor map gets is a multiple of 16
    bytes."""
    st = list(t.stride()[:3])
    inner = t.shape[3]                     # the last dimension is contiguous
    for d in (2, 1, 0):
        if t.shape[d] == 1:
            st[d] = inner
        inner = st[d] * t.shape[d]
    return tuple(st)


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


def unmasked_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """The (query row, key) pairs of one (batch, head) that
    ``attention_mask`` lets through, counted without building it."""
    p = np.arange(sq, dtype=np.int64) + (sk - sq)      # query positions
    hi = np.minimum(p, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(p - window + 1, 0) if window > 0 else np.zeros(sq, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_attention_cost(q, k, v, *, causal: bool = True, window: int = 0):
    """(FLOPs, bytes) of one ``flash_attention`` launch: 4 hd FLOPs an
    unmasked (query, key) pair of each query head (the two products); q,
    k and v read once and the output (q's shape and dtype) written once."""
    B, Sq, H, hd = q.shape
    pairs = B * H * unmasked_pairs(Sq, k.shape[1], causal, window)
    return (4 * hd * pairs,
            q.element_size() * (2 * q.numel() + k.numel() + v.numel()))


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
    in place through their strides: fp32 runs ``flash_attention.cu`` (the
    last dimension contiguous, hd a multiple of 4 and at most 256, the
    other strides multiples of 4), bf16 ``flash_attention_bf16.cu``
    (``check_bf16_operands``)."""
    _check(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    refuse_autograd("flash_attention", q, k, v)
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    name = "flash_attention_bf16" if bf16 else "flash_attention"
    if not bf16 and (hd % 4 or not 0 < hd <= MAX_HEAD_DIM):
        raise ValueError(f"head_dim must be a multiple of 4 in [4, "
                         f"{MAX_HEAD_DIM}], got {hd}")
    if costs.is_fake(q):
        return costs.fake_launch(name, flash_attention_cost,
                                 torch.empty_like(q), q, k, v, causal=causal,
                                 window=window)
    if bf16:
        check_bf16_operands(q, k, v)
    else:
        for arg, t in (("q", q), ("k", k), ("v", v)):
            if t.stride(3) != 1 or any(s % 4 for s in t.stride()[:3]) or \
                    t.data_ptr() % 16:
                raise ValueError(f"{arg} needs a contiguous last dimension, "
                                 f"strides that are multiples of 4 and a "
                                 f"16-byte aligned start; got strides "
                                 f"{t.stride()}")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if Sk == 0:
        raise ValueError("attention over no keys")
    if max(Sq, Sk) + abs(Sk - Sq) >= 2**31:
        raise ValueError(f"Sq = {Sq}, Sk = {Sk}: positions past an int32")
    if bf16:
        strides = (*q.stride()[:3], *_tma_strides(k), *_tma_strides(v))
        block = bf16_block_rows(B, Sq, H, K, hd)
    else:
        strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
        block = attention_warps(B, Sq, H, K, hd)
    err = build.load(name, _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, K, hd, *strides, int(causal), int(window), Sk - Sq,
        block, q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launch_counts[name] += 1
    costs.record(name, flash_attention_cost, q, k, v,
                 causal=causal, window=window)
    return out
