"""Hierarchical weighted aggregation (eqs. 6/10) on the flat ``(N, F)``
buffer: the wrappers of the four CUDA kernels and their plain versions.

* ``segment_aggregate`` — edge aggregation (eq. 6): per-edge weighted
  segment mean fused with the scatter-back to the members' rows.  Kernel
  ``csrc/segment_aggregate.cu``; replaces the TPU kernel
  ``hier_segment_aggregate_2d`` (``repro/kernels/hier_aggregate.py:182``).
* ``cloud_aggregate``   — cloud aggregation (eq. 10): the global weighted
  mean fused with the broadcast-back.  Kernel ``csrc/cloud_aggregate.cu``;
  replaces ``hier_bcast_aggregate_2d`` (``hier_aggregate.py:117``).
* ``weighted_mean``     — the reduce-only weighted mean ``(N, F) -> (F,)``:
  each data shard's local step of the sharded cloud event.  Kernel
  ``csrc/weighted_mean.cu``; replaces ``hier_aggregate_2d``
  (``hier_aggregate.py:62``).
* ``segment_sum``       — the chunk step of the streaming edge accumulator:
  per-edge weighted sums of a chunk of rows, added into an ``(M, F)``
  accumulator.  Kernel ``csrc/segment_sum.cu``; replaces
  ``hier_segment_sum_2d`` (``hier_aggregate.py:263``).

All four share their row sums (``csrc/segment_core.cuh``; ``cloud_aggregate``
and ``weighted_mean`` take its one-group case) and are one launch a call
each; their wrappers pick the load width from x's row length and address
(``load_width``), the warps a block (``block_warps``) and the row slices
of ``segment_sum`` and ``weighted_mean`` (``segment_sum_plan``,
``weighted_mean_plan``), and keep the slices' workspace per device
(``_workspace``).

A wrapper takes the plain PyTorch version only for a tensor on the CPU.
For a CUDA tensor it launches its kernel on the current stream or raises;
it never falls back.  ``launch_counts`` (held by
``repro_torch.tracing``'s registry) counts the launches, so a run can
show that its aggregation events went through the kernels; each launch
also hands its cost (``*_cost``) to the running cost walks
(``kernels.costs``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import tracing
from repro_torch.kernels import build, costs
from repro_torch.launch.mesh import NUM_SMS

TILE = 128                     # columns per block, as in csrc/*.cu
SMEM_BYTES = 232_448           # the shared memory an H100 block may use
#: Most groups ``segment_aggregate`` and ``segment_sum`` take: one warp's
#: (M, TILE) sums and (M,) weight sums live in one block's shared memory.
MAX_GROUPS = SMEM_BYTES // (4 * (TILE + 1))
#: Most warps a block of the four kernels splits its rows over, and the
#: rows a warp loads at once (``csrc/segment_core.cuh``; 16 in the
#: one-group kernels' bf16, which keep them packed).
MAX_WARPS = 16
WARP_ROWS = 8
#: Warps an SM holds at once at those kernels' 63-80 registers a thread
#: (ptxas, ``chip_smoke.py`` phase 1): three 8-warp blocks.  Their grids
#: stay within one wave of that.
RESIDENT_WARPS = 24
#: The same for ``cloud_aggregate`` and ``weighted_mean`` (one group: no
#: per-group slots) at their 58-64 registers a thread in fp32: 32 warps.
#: (Their bf16 kernels, 16 rows a batch, take 70-83: 24 warps.)
ONE_GROUP_RESIDENT_WARPS = 32
#: ``weighted_mean``'s plan: blocks of at most ``MEAN_WARPS`` warps, and
#: row slices for about ``MEAN_WAVES`` waves of them, at most
#: ``MEAN_MAX_SLICES`` (the last block of a column tile adds its slices'
#: partials one L2 round trip per 8).  At a 16,384 x 44,426 shard on an
#: H100, 12 slices of 8 warps (7.9 waves) took 967 us in fp32 and 503 us in
#: bf16, 3 slices of 4 warps (one wave) 1,001 and 602 us
#: (``chip_smoke.py`` phase 2 sweeps them on every run).
MEAN_WARPS = 8
MEAN_WAVES = 8
MEAN_MAX_SLICES = 32
#: ``segment_sum`` splits the rows into slices for about one block per SM
#: (a column tile and a slice a block), of at least ``MIN_SLICE_ROWS``
#: rows each.
MIN_SLICE_ROWS = 64

launch_counts = tracing.launch_counts("segment_aggregate", "cloud_aggregate",
                                      "segment_sum", "weighted_mean")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_ARGTYPES = {
    "segment_aggregate": [_P, _P, _P, _P, _I64, _I64, _INT, _INT, _INT, _INT,
                          _INT, _P],
    "cloud_aggregate": [_P, _P, _P, _I64, _I64, _INT, _INT, _INT, _INT,
                        _P],
    "segment_sum": [_P, _P, _P, _P, _P, _P, _I64, _I64, _INT, _I64, _INT,
                    _INT, _INT, _INT, _INT, _P],
    "weighted_mean": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _INT, _INT,
                      _INT, _INT, _INT, _P],
}


#: Per device: the tile counters of ``segment_sum`` and ``weighted_mean``
#: (int32, zeroed once; the kernels leave them 0) and their fp32 workspace
#: of the slices' partial sums, grown on demand, so that a call allocates
#: nothing.  The port launches on one stream: two launches on two streams
#: at once would share them.
_scratch: dict = {}


def _check(x, w, group_ids=None):
    if x.dim() != 2:
        raise ValueError(f"x must be (N, F), got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    n = x.shape[0]
    args = [("x", x, None), ("w", w, torch.float32)]
    if group_ids is not None:
        args.append(("group_ids", group_ids, torch.int32))
    for name, t, dtype in args:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if dtype is not None and (t.dtype != dtype or tuple(t.shape) != (n,)):
            raise ValueError(f"{name} must be ({n},) {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _check_groups(num_groups) -> int:
    num_groups = int(num_groups)
    if not 1 <= num_groups <= MAX_GROUPS:
        raise ValueError(f"num_groups must be in [1, {MAX_GROUPS}], got "
                         f"{num_groups}")
    return num_groups


def _launch(name, *args):
    err = build.load(name, _ARGTYPES[name])(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launch_counts[name] += 1


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the CPU path and the oracle the kernels are held to.
# ---------------------------------------------------------------------------


def segment_aggregate_plain(x, w, group_ids, num_groups: int):
    gid = group_ids.long()
    xf = x.to(torch.float32)
    acc = torch.zeros(num_groups, x.shape[1], dtype=torch.float32,
                      device=x.device).index_add_(0, gid, w[:, None] * xf)
    gw = torch.zeros(num_groups, dtype=torch.float32,
                     device=x.device).index_add_(0, gid, w)
    mean = acc / gw.clamp_min(1e-12)[:, None]
    return mean[gid]


def cloud_aggregate_plain(x, w):
    mean = (w[:, None] * x.to(torch.float32)).sum(0) / w.sum()
    return mean[None].expand(x.shape).contiguous()


def weighted_mean_plain(x, w):
    return (w[:, None] * x.to(torch.float32)).sum(0) / w.sum()


def segment_sum_plain(x, w, group_ids, num_groups: int):
    return torch.zeros(num_groups, x.shape[1], dtype=torch.float32,
                       device=x.device).index_add_(
        0, group_ids.long(), w[:, None] * x.to(torch.float32))


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Costs of one launch (``costs.record``): a multiply and an add an element
# of x; each input read once, each output written once.
# ---------------------------------------------------------------------------


def segment_aggregate_cost(x, w, group_ids, num_groups: int):
    """(FLOPs, bytes) of one ``segment_aggregate`` launch: x, w and the
    group ids read, the (N, F) fp32 result written."""
    n, f = x.shape
    return 2 * n * f, n * f * (x.element_size() + 4) + 8 * n


def cloud_aggregate_cost(x, w):
    """(FLOPs, bytes) of one ``cloud_aggregate`` launch: x and w read, the
    (N, F) fp32 result written."""
    n, f = x.shape
    return 2 * n * f, n * f * (x.element_size() + 4) + 4 * n


def weighted_mean_cost(x, w):
    """(FLOPs, bytes) of one ``weighted_mean`` launch: x and w read, the
    (F,) fp32 mean written."""
    n, f = x.shape
    return 2 * n * f, n * f * x.element_size() + 4 * n + 4 * f


def segment_sum_cost(x, w, group_ids, num_groups: int):
    """(FLOPs, bytes) of one ``segment_sum`` launch: x, w and the group ids
    read, the (M, F) fp32 accumulator read and written."""
    n, f = x.shape
    return 2 * n * f, n * f * x.element_size() + 8 * n + 8 * num_groups * f


def load_width(n_cols: int, element_size: int, data_ptr: int) -> int:
    """Elements of x per load in the four kernels: 4, 2 or 1, the widest
    that divides the row's length and whose bytes divide x's address (16-,
    8- or 4-byte loads in fp32; 8, 4 or 2 bytes in bf16)."""
    for vec in (4, 2):
        if n_cols % vec == 0 and data_ptr % (vec * element_size) == 0:
            return vec
    return 1


def block_warps(rows: int, blocks: int, slot_floats: int,
                resident: int = RESIDENT_WARPS) -> int:
    """Warps of each of ``blocks`` blocks over ``rows`` rows: a power of
    two, one a ``WARP_ROWS`` rows (so that a warp has all its rows' loads
    in flight at once), at most ``MAX_WARPS``, no more than keep the grid
    within one wave of ``resident`` warps an SM, and no more than whose
    ``slot_floats``-float slots fit in shared memory."""
    warps = 1
    while (warps < MAX_WARPS and warps * WARP_ROWS < rows
           and 2 * warps * blocks <= resident * NUM_SMS
           and 2 * warps * slot_floats * 4 <= SMEM_BYTES):
        warps *= 2
    return warps


def segment_aggregate_warps(n_rows: int, n_cols: int, num_groups: int) -> int:
    """Warps a ``segment_aggregate`` block (one column tile, every row)
    splits its rows over: each holds (M, TILE) sums and (M,) weights."""
    return block_warps(n_rows, -(-n_cols // TILE), num_groups * (TILE + 1))


def segment_aggregate(x, w, group_ids, num_groups: int):
    """Edge aggregation (eq. 6).  x: (N, F) fp32|bf16, w: (N,) fp32,
    group_ids: (N,) int32 in [0, num_groups) -> (N, F) fp32 with
    ``out[n] = sum_{i in g(n)} w_i x_i / max(sum_{i in g(n)} w_i, 1e-12)``.
    """
    _check(x, w, group_ids)
    num_groups = _check_groups(num_groups)
    if x.device.type == "cpu":
        return segment_aggregate_plain(x, w, group_ids, num_groups)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if out.numel():
        n, f = x.shape
        _launch("segment_aggregate", x.data_ptr(), w.data_ptr(),
                group_ids.data_ptr(), out.data_ptr(), n, f, num_groups,
                segment_aggregate_warps(n, f, num_groups),
                load_width(f, x.element_size(), x.data_ptr()),
                int(x.dtype == torch.bfloat16), x.device.index or 0,
                torch.cuda.current_stream(x.device).cuda_stream)
        costs.record("segment_aggregate", segment_aggregate_cost, x, w,
                     group_ids, num_groups)
    return out


def cloud_aggregate_warps(n_rows: int, n_cols: int) -> int:
    """Warps a ``cloud_aggregate`` block (one column tile, every row)
    splits its rows over: ``block_warps`` at the one-group kernels'
    ``ONE_GROUP_RESIDENT_WARPS``."""
    return block_warps(n_rows, -(-n_cols // TILE), TILE + 1,
                       ONE_GROUP_RESIDENT_WARPS)


def cloud_aggregate(x, w):
    """Cloud aggregation (eq. 10).  x: (N, F) fp32|bf16, w: (N,) fp32 ->
    (N, F) fp32 with every row ``sum_n w_n x_n / sum_n w_n``.  No guard:
    all-zero weights give NaN, as in the reference."""
    _check(x, w)
    if x.device.type == "cpu":
        return cloud_aggregate_plain(x, w)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if out.numel():
        n, f = x.shape
        _launch("cloud_aggregate", x.data_ptr(), w.data_ptr(),
                out.data_ptr(), n, f, cloud_aggregate_warps(n, f),
                load_width(f, x.element_size(), x.data_ptr()),
                int(x.dtype == torch.bfloat16), x.device.index or 0,
                torch.cuda.current_stream(x.device).cuda_stream)
        costs.record("cloud_aggregate", cloud_aggregate_cost, x, w)
    return out


def weighted_mean_plan(n_rows: int, n_cols: int):
    """``(slices, rows per slice, warps per block)`` of a ``weighted_mean``
    launch, a block a column tile and row slice: a power of two of warps,
    one a ``WARP_ROWS`` rows, at most ``MEAN_WARPS``; slices for the most
    blocks within ``MEAN_WAVES`` waves of ``ONE_GROUP_RESIDENT_WARPS``
    warps an SM, at most ``MEAN_MAX_SLICES`` and at least ``WARP_ROWS``
    rows a warp.  Many whole waves, so that a last one short of blocks
    costs little.  One slice when the rows are fewer than two load
    batches a warp (phase 9's 60-row slab: its 348 tiles fill the card)."""
    tiles = -(-n_cols // TILE)
    warps = 1
    while warps < MEAN_WARPS and warps * WARP_ROWS < n_rows:
        warps *= 2
    per_wave = NUM_SMS * (ONE_GROUP_RESIDENT_WARPS // warps)   # blocks
    slices = max(1, min(MEAN_WAVES * per_wave // tiles, MEAN_MAX_SLICES,
                        n_rows // (warps * WARP_ROWS)))
    rows = max(1, -(-n_rows // slices))
    return max(1, -(-n_rows // rows)), rows, warps


def weighted_mean(x, w):
    """Weighted mean over the rows.  x: (N, F) fp32|bf16, w: (N,) fp32 ->
    (F,) fp32 ``sum_n w_n x_n / sum_n w_n``.  No guard: all-zero weights
    give 0/0 = NaN, as in the reference."""
    _check(x, w)
    if x.device.type == "cpu":
        return weighted_mean_plain(x, w)
    n, f = x.shape
    out = torch.empty(f, dtype=torch.float32, device=x.device)
    if f:
        slices, rows, warps = weighted_mean_plan(n, f)
        counters = ws = None
        if slices > 1:
            tiles = -(-f // TILE)
            counters, ws = _workspace(x.device, tiles,
                                      tiles * slices * (TILE + 4))
        _launch("weighted_mean", x.data_ptr(), w.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(),
                None if counters is None else counters.data_ptr(), n, f,
                rows, slices, warps,
                load_width(f, x.element_size(), x.data_ptr()),
                int(x.dtype == torch.bfloat16), x.device.index or 0,
                torch.cuda.current_stream(x.device).cuda_stream)
        costs.record("weighted_mean", weighted_mean_cost, x, w)
    return out


def segment_sum_plan(n_rows: int, n_cols: int, num_groups: int):
    """``(slices, rows per slice, warps per block)`` of a ``segment_sum``
    launch: enough row slices for about one block per SM with one block a
    column tile and slice, of at least ``MIN_SLICE_ROWS`` rows each (one
    slice when the column tiles alone fill the card), and the warps that
    ``block_warps`` gives a slice's rows."""
    tiles = -(-n_cols // TILE)
    slices = max(1, min(NUM_SMS // tiles, n_rows // MIN_SLICE_ROWS))
    rows = max(1, -(-n_rows // slices))
    slices = -(-n_rows // rows)
    return slices, rows, block_warps(rows, tiles * slices, num_groups * TILE)


def _workspace(device, tiles: int, floats: int):
    """The device's tile counters (at least ``tiles``) and workspace (at
    least ``floats``), grown when a launch needs more."""
    counters, ws = _scratch.get(device, (None, None))
    if counters is None or counters.numel() < tiles:
        counters = torch.zeros(max(tiles, NUM_SMS), dtype=torch.int32,
                               device=device)
    if ws is None or ws.numel() < floats:
        ws = torch.empty(max(floats, 1 << 16), dtype=torch.float32,
                         device=device)
    _scratch[device] = counters, ws
    return counters, ws


def segment_sum(x, w, group_ids, num_groups: int, out=None):
    """Per-group weighted sums, added into ``out``.  x: (N, F) fp32|bf16,
    w: (N,) fp32, group_ids: (N,) int32 in [0, num_groups); ``out``: an
    (num_groups, F) fp32 accumulator, or None for a fresh zero one.
    Returns ``out`` with ``out[m] += sum_{n: g(n) = m} w_n x_n`` (each
    chunk sum formed first, then added).  No normalisation, no
    scatter-back."""
    _check(x, w, group_ids)
    num_groups = _check_groups(num_groups)
    shape = (num_groups, x.shape[1])
    if out is None:
        out = torch.zeros(shape, dtype=torch.float32, device=x.device)
    elif (tuple(out.shape) != shape or out.dtype != torch.float32
          or out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {shape} float32 tensor "
                         f"on {x.device}, got {tuple(out.shape)} "
                         f"{out.dtype} on {out.device}")
    if x.device.type == "cpu":
        return out.add_(segment_sum_plain(x, w, group_ids, num_groups))
    if x.numel():
        n, f = x.shape
        slices, rows, warps = segment_sum_plan(n, f, num_groups)
        counters = ws = None
        if slices > 1:
            tiles = -(-f // TILE)
            counters, ws = _workspace(x.device, tiles,
                                      tiles * slices * num_groups * TILE)
        _launch("segment_sum", x.data_ptr(), w.data_ptr(),
                group_ids.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(),
                None if counters is None else counters.data_ptr(), n, f,
                num_groups, rows, slices, warps,
                load_width(f, x.element_size(), x.data_ptr()),
                int(x.dtype == torch.bfloat16), x.device.index or 0,
                torch.cuda.current_stream(x.device).cuda_stream)
        costs.record("segment_sum", segment_sum_cost, x, w, group_ids,
                     num_groups)
    return out
