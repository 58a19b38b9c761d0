"""One-token GQA attention over a ring KV cache (the decode step): the
wrapper of the CUDA kernels ``csrc/decode_attention.cu`` (fp32, split-TF32
``mma.sync``) and ``csrc/decode_attention_bf16.cu`` (bf16: TMA tiles, bf16
``mma.sync``) and their plain version.  Replaces the TPU kernel
``decode_attention_bk`` (``repro/kernels/decode_attention.py:66``, wrapper
``repro/kernels/ops.py:187``).

Layouts are the JAX package's: q ``(B, 1, H, hd)``, the caches
``(B, W, K, hd)`` with ``H`` a multiple of ``K``, ``slot_pos (W,)`` int32
(the absolute position held by each slot, negative for a slot never
written) and ``pos`` the current position, a 0-d int32 tensor.  A slot
counts if ``0 <= slot_pos <= pos`` and, with a window,
``pos - slot_pos < window``.

A wrapper takes the plain PyTorch version only for a tensor on the CPU.
For a CUDA tensor it launches its kernel on the current stream or raises;
it never falls back.  The kernel has no backward: on the card the wrapper
raises on inputs that require grad and under ``torch.func`` transforms
(``grad_guard``).  ``launch_counts`` (held by ``repro_torch.tracing``'s
registry) counts the launches under the kernel launched
(``decode_attention`` in fp32, ``decode_attention_bf16`` in bf16), so a
run can show that its decode steps went through the kernel; each launch
also hands its cost (``decode_attention_cost``) to the running cost walks
(``kernels.costs``) under the same name.

On the card the slots are dealt in tiles round-robin to the splits of
each (batch, KV head), a block each: 32-slot tiles in fp32
(``decode_splits``), 64-slot tiles through a ring of ``decode_bf16_stages``
stages in bf16 (``decode_bf16_splits``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import tracing
from repro_torch.kernels import build, costs
from repro_torch.kernels.flash_attention import _tma_strides, head_dim_class
from repro_torch.kernels.grad_guard import refuse_autograd
from repro_torch.launch.mesh import NUM_SMS

NEG_INF = -2.0e38
MAX_HEAD_DIM = 256
MAX_GROUP = 32                 # query heads per KV head: 2 m-tiles of 16
#                                (bf16: 2 blocks of 16, ``bf16_head_blocks``)
TILE = 32                      # slots per tile, as in csrc/decode_attention.cu
MAX_TILES_PER_SPLIT = 4096     # the tile masks a block keeps in shared memory
MAX_GRID_Y = 65_535
# csrc/decode_attention_bf16.cu: 64-slot tiles (one TMA box a 64-column
# panel), their 64-bit masks in shared memory, and a ring that keeps
# BF16_IN_FLIGHT bytes of K and V on their way to each block (a block an
# SM): 3.35 TB/s over 132 SMs is ~25 bytes a ns an SM, so ~50 KB cover a
# loaded HBM latency of ~2 us; twice that lets a tile's products overlap.
BF16_TILE = 64
BF16_MAX_TILES_PER_SPLIT = 2048
BF16_IN_FLIGHT = 128 * 1024
BF16_MAX_STAGES = 8

launch_counts = tracing.launch_counts("decode_attention",
                                      "decode_attention_bf16")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
# pointers, 16 sizes and strides, then device (fp32) or stages, tma and
# device (bf16), and the stream
_ARGTYPES = [_P] * 8 + [_I64] * 16 + [_INT] + [_P]
_BF16_ARGTYPES = [_P] * 8 + [_I64] * 16 + [_INT] * 3 + [_P]

#: Per device: the splits' barrier words, one 64-bit (generation, count) a
#: (batch, KV head), as two int32 zeroed once (the kernel leaves the counts
#: 0), and the fp32 workspace of the blocks' partials, both grown on
#: demand.  A fixed address lets a later CUDA graph of the decode step
#: capture them.  The port launches on one stream: two launches on two
#: streams at once would share them.
_scratch: dict = {}


def valid_slots(slot_pos, pos, window: int = 0):
    """(W,) bool: the ring slots that the token at ``pos`` attends to."""
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window > 0:
        valid &= (pos - slot_pos) < window
    return valid


def decode_attention_cost(q, k_cache, v_cache, slot_pos, pos, *,
                          window: int = 0):
    """(FLOPs, bytes) of one ``decode_attention`` launch, over the slots
    that count in this input alone (a device read): 4 hd FLOPs a counted
    slot of each query head; their K and V rows, q, the output (q's shape
    and dtype), ``slot_pos`` and ``pos`` moved once."""
    B, _, H, hd = q.shape
    if costs.is_fake(slot_pos):
        # no positions to read: a ring whose every slot holds a token
        # (a decode with its context full), the dry run's decode step
        W = slot_pos.shape[0]
        n = min(W, window) if window > 0 else W
    else:
        n = int(valid_slots(slot_pos, pos, window).sum())
    return (4 * B * H * hd * n,
            q.element_size() * (2 * B * k_cache.shape[2] * hd * n
                                + 2 * q.numel())
            + slot_pos.element_size() * (slot_pos.numel() + 1))


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
    """``(splits, most tiles of a split)`` for ``bk`` (batch, KV head) pairs
    over ``w`` slots.  The 32-slot tiles are dealt round-robin: split x
    takes tiles x, x + splits, ...  The rule gives each SM one block
    (``NUM_SMS // bk`` splits), never more splits than tiles.  With more
    than one split the launch is cooperative: all its blocks are resident
    at once, as the splits' barrier needs, and one block an SM always fits
    (at head dims above 64 a block takes 150-210 KB of shared memory)."""
    tiles = -(-w // TILE)
    s = max(1, min(NUM_SMS // bk, tiles), -(-tiles // MAX_TILES_PER_SPLIT))
    return s, -(-tiles // s)


def decode_smem_bytes(hd: int, g: int, w: int, splits: int) -> int:
    """Shared memory of one fp32 block, as ``Layout`` in
    ``decode_attention.cu`` lays it out: the 8 compute warps' partial
    scores of one tile; P's fragments of one tile per m-tile; a region that
    holds the K/V ring (2 stages at head dims above 128, else 4), then
    (with one split) the block's partial; one mask per tile of the split;
    ``Misc``."""
    def up(x, m):
        return -(-x // m) * m
    mt = 1 if g <= 16 else 2
    nt = 8 if hd <= 64 else 16 if hd <= 128 else 32
    stages = 2 if nt * 4 >= 128 else 4
    ring = stages * 2 * TILE * (up(hd, 32) + 4) * 4
    merge = 4 * g * hd
    tiles = -(-w // TILE)
    masks = 4 * -(-tiles // splits)
    misc = 12 * 8 + 4 * (2 * 2 * 4 * 16 + 2 * MAX_GROUP)
    return (8 * 4 * 32 * 16 + mt * 4 * 64 * 16 + up(max(ring, merge), 16)
            + up(masks, 16) + up(misc, 16))


def decode_bf16_stages(hd: int) -> int:
    """Stages of the bf16 kernel's ring: as many K and V tiles of
    ``BF16_TILE`` slots as make ``BF16_IN_FLIGHT`` bytes, 2 to
    ``BF16_MAX_STAGES``: 8, 4, 2 at head-dim classes 64, 128, 256 (an even
    number: two groups of warps take alternate tiles)."""
    stage = 2 * BF16_TILE * head_dim_class(hd) * 2
    return max(2, min(BF16_MAX_STAGES, BF16_IN_FLIGHT // stage))


def bf16_head_blocks(g: int) -> int:
    """Blocks of the bf16 kernel a (batch, KV head): one for each 16 of its
    ``g`` query heads."""
    return -(-g // 16)


def decode_bf16_splits(bk: int, w: int, g: int):
    """``(splits, most tiles of a split)`` of the bf16 kernel for ``bk``
    (batch, KV head) pairs of ``g`` query heads over ``w`` slots: its
    ``BF16_TILE``-slot tiles dealt round-robin as in ``decode_splits``, to
    a block an SM (``NUM_SMS // (bk * bf16_head_blocks(g))`` splits), never
    more splits than tiles.  A block holds most of an SM's shared memory
    (``decode_bf16_smem_bytes``), so the blocks of a cooperative launch
    all fit at once."""
    tiles = -(-w // BF16_TILE)
    s = max(1, min(NUM_SMS // (bk * bf16_head_blocks(g)), tiles),
            -(-tiles // BF16_MAX_TILES_PER_SPLIT))
    return s, -(-tiles // s)


def decode_bf16_smem_bytes(hd: int, w: int, splits: int) -> int:
    """Shared memory of one bf16 block, as ``Layout`` in
    ``decode_attention_bf16.cu`` lays it out: 1,024 bytes of alignment
    slack; a region that holds the ring (``decode_bf16_stages`` stages of
    a K and a V tile, ``BF16_TILE`` rows by the head-dim class) and, after
    the loop, the consumer warps' partials (16 rows of the class plus 4
    fp32 each; 8 warps, 4 at head dim 256); Q's 16 rows; a 64-bit mask per
    tile of the split; three barriers a stage; the merge's row maxima and
    sums."""
    c, stages = head_dim_class(hd), decode_bf16_stages(hd)
    warps = 4 if c == 256 else 8
    region = max(stages * 2 * BF16_TILE * c * 2, warps * 16 * (c + 4) * 4)
    q = -(-region // 1024) * 1024
    tiles = -(-w // BF16_TILE)
    masks = q + 16 * c * 2
    bars = masks + 8 * -(-tiles // splits)
    misc = bars + 3 * 8 * stages
    return 1024 + misc + 4 * (2 * 8 * 16 + 2 * 16)


def _scratch_for(device, pairs: int, floats: int):
    """The device's counters (at least ``pairs``) and workspace (at least
    ``floats``), grown when a launch needs more."""
    counters, ws = _scratch.get(device, (None, None))
    if counters is None or counters.numel() < pairs:
        counters = torch.zeros(max(pairs, 256), dtype=torch.int32,
                               device=device)
    if ws is None or ws.numel() < floats:
        ws = torch.empty(max(floats, 1 << 16), dtype=torch.float32,
                         device=device)
    _scratch[device] = counters, ws
    return counters, ws


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


#: Launch plans by layout: what a launch needs that the shapes, strides,
#: dtypes and devices decide, checked once (the decode step calls the
#: kernel with the same layout every layer and step, and its host work
#: sets the step's time).
_plans: dict = {}


def _plan(q, k_cache, v_cache, slot_pos, pos, key):
    """The checks of a CUDA launch and its layout-decided arguments."""
    _check(q, k_cache, v_cache, slot_pos, pos)
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
    bf16 = q.dtype == torch.bfloat16
    # the grid's (batch, KV head) blocks: in bf16 one for each 16 query heads
    pairs = B * K * (bf16_head_blocks(g) if bf16 else 1)
    if pairs > MAX_GRID_Y:
        raise ValueError(f"{pairs} (batch, KV head) blocks > {MAX_GRID_Y}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.stride(3) != 1 or any(s % 4 for s in t.stride()[:3]):
            raise ValueError(f"{name} needs a contiguous last dimension and "
                             f"strides that are multiples of 4; got strides "
                             f"{t.stride()}")
    if W == 0 and B * H * hd:
        raise ValueError("attention over an empty cache of 0 slots")
    device = q.device.index or 0
    if bf16:
        splits = decode_bf16_splits(B * K, W, g)[0] if W else 1
        rows = pairs * 16                  # the blocks' partials: 16 heads
        ks, vs = _tma_strides(k_cache), _tma_strides(v_cache)
        plan = dict(name="decode_attention_bf16", argtypes=_BF16_ARGTYPES,
                    align=8, splits=splits,
                    # TMA's tensor maps take hd and the strides in 16-byte
                    # units; the kernel's threads copy other rows
                    tma=hd % 8 == 0 and not any(x % 8 for x in ks + vs),
                    args=(B, W, H, K, hd, q.stride(0), q.stride(2), *ks,
                          *vs, slot_pos.stride(0)),
                    flags=(decode_bf16_stages(hd),))
    else:
        splits = decode_splits(B * K, W)[0] if W else 1
        rows = pairs * g
        plan = dict(name="decode_attention", argtypes=_ARGTYPES, align=16,
                    splits=splits, tma=False,
                    args=(B, W, H, K, hd, q.stride(0), q.stride(2),
                          *k_cache.stride()[:3], *v_cache.stride()[:3],
                          slot_pos.stride(0)),
                    flags=())
    # a 64-bit barrier word (two int32) a block of the grid's y, and the
    # fp32 workspace of the splits' partials (acc rows, m, l)
    plan.update(out=(B, 1, H, hd), device=device,
                scratch=(2 * pairs, rows * splits * (hd + 2)))
    _plans[key] = plan
    return plan


def decode_attention(q, k_cache, v_cache, slot_pos, pos, *, window: int = 0):
    """One-token GQA ring-cache attention.  q: (B, 1, H, hd), caches
    (B, W, K, hd), fp32 or bf16; slot_pos (W,) int32; pos a 0-d int32
    tensor -> (B, 1, H, hd) of q's dtype.  On the card ``pos`` and
    ``slot_pos`` are read in device memory (no host sync) and q and the
    caches in place through their strides: the last dimension contiguous,
    hd a multiple of 4 and at most 256, the other strides multiples of 4,
    at most ``MAX_GROUP`` query heads per KV head; 16-byte aligned starts
    in fp32, 8-byte in bf16.  fp32 runs ``decode_attention.cu``, bf16
    ``decode_attention_bf16.cu``."""
    name = "decode_attention_bf16" if q.dtype == torch.bfloat16 \
        else "decode_attention"
    if q.device.type == "cpu":
        _check(q, k_cache, v_cache, slot_pos, pos)
        return decode_attention_plain(q, k_cache, v_cache, slot_pos, pos,
                                      window=window)
    if costs.is_fake(q):
        _check(q, k_cache, v_cache, slot_pos, pos)
        return costs.fake_launch(name, decode_attention_cost,
                                 torch.empty_like(q), q, k_cache, v_cache,
                                 slot_pos, pos, window=window)
    refuse_autograd(name, q, k_cache, v_cache)
    key = (q.shape, q.stride(), q.dtype, q.device, k_cache.shape,
           k_cache.stride(), k_cache.dtype, k_cache.device, v_cache.shape,
           v_cache.stride(), v_cache.dtype, v_cache.device, slot_pos.shape,
           slot_pos.stride(), slot_pos.dtype, slot_pos.device, pos.shape,
           pos.dtype, pos.device)
    plan = _plans.get(key) or _plan(q, k_cache, v_cache, slot_pos, pos, key)
    out = torch.empty(plan["out"], dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    ptrs = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr())
    if any(x % plan["align"] for x in ptrs):
        raise ValueError(f"q and the caches need {plan['align']}-byte "
                         f"aligned starts; got addresses {ptrs}")
    counters, ws = _scratch_for(q.device, *plan["scratch"])
    flags = plan["flags"]
    if name == "decode_attention_bf16":
        flags += (int(plan["tma"] and not any(x % 16 for x in ptrs[1:])),)
    err = build.load(name, plan["argtypes"])(
        *ptrs, slot_pos.data_ptr(), pos.data_ptr(), out.data_ptr(),
        ws.data_ptr(), counters.data_ptr(), *plan["args"], int(window),
        plan["splits"], *flags, plan["device"],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launch_counts[name] += 1
    costs.record(name, decode_attention_cost, q, k_cache, v_cache, slot_pos,
                 pos, window=window)
    return out
