"""Hierarchical weighted aggregation (eqs. 6/10) on the flat ``(N, F)``
buffer: the wrappers of the three CUDA kernels and their plain versions.

* ``segment_aggregate`` — edge aggregation (eq. 6): per-edge weighted
  segment mean fused with the scatter-back to the members' rows.  Kernel
  ``csrc/segment_aggregate.cu``; replaces the TPU kernel
  ``hier_segment_aggregate_2d`` (``repro/kernels/hier_aggregate.py:182``).
* ``cloud_aggregate``   — cloud aggregation (eq. 10): the global weighted
  mean fused with the broadcast-back.  Kernel ``csrc/cloud_aggregate.cu``;
  replaces ``hier_bcast_aggregate_2d`` (``hier_aggregate.py:117``).
* ``segment_sum``       — the chunk step of the streaming edge accumulator:
  per-edge weighted sums of a chunk of rows, added into an ``(M, F)``
  accumulator.  Kernel ``csrc/segment_sum.cu``; replaces
  ``hier_segment_sum_2d`` (``hier_aggregate.py:263``).

A wrapper takes the plain PyTorch version only for a tensor on the CPU.
For a CUDA tensor it launches its kernel on the current stream or raises;
it never falls back.  ``launch_counts`` counts the launches, so a run can
show that its aggregation events went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

TILE = 128                     # columns per block, as in csrc/*.cu
ROWS = 16                      # rows per step of the kernels' row loops
SMEM_BYTES = 232_448           # the shared memory an H100 block may use
NUM_SMS = 132                  # streaming multiprocessors of an H100 SXM
#: Most groups ``segment_aggregate`` and ``segment_sum`` take: the (M, TILE)
#: sums (and ``segment_aggregate``'s (M,) weight sums) live in one block's
#: shared memory.
MAX_GROUPS = SMEM_BYTES // (4 * (TILE + 1))
#: ``segment_sum`` splits the rows into slices, for about this many blocks
#: per SM (at the streaming chunk, 8192 x 1024, four came out faster than
#: two or eight: ``chip_smoke.py`` phase 2 times all three), of at least
#: ``MIN_SLICE_ROWS`` rows each.
BLOCKS_PER_SM = 4
MIN_SLICE_ROWS = 64

launch_counts = {"segment_aggregate": 0, "cloud_aggregate": 0,
                 "segment_sum": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_ARGTYPES = {
    "segment_aggregate": [_P, _P, _P, _P, _I64, _I64, _INT, _INT, _INT, _P],
    "cloud_aggregate": [_P, _P, _P, _I64, _I64, _INT, _INT, _P],
    "segment_sum": [_P, _P, _P, _P, _P, _I64, _I64, _INT, _I64, _INT, _INT,
                    _INT, _P],
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


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


def segment_sum_plain(x, w, group_ids, num_groups: int):
    return torch.zeros(num_groups, x.shape[1], dtype=torch.float32,
                       device=x.device).index_add_(
        0, group_ids.long(), w[:, None] * x.to(torch.float32))


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------


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
        _launch("segment_aggregate", x.data_ptr(), w.data_ptr(),
                group_ids.data_ptr(), out.data_ptr(), x.shape[0],
                x.shape[1], num_groups, int(x.dtype == torch.bfloat16),
                x.device.index or 0,
                torch.cuda.current_stream(x.device).cuda_stream)
    return out


def cloud_aggregate(x, w):
    """Cloud aggregation (eq. 10).  x: (N, F) fp32|bf16, w: (N,) fp32 ->
    (N, F) fp32 with every row ``sum_n w_n x_n / sum_n w_n``."""
    _check(x, w)
    if x.device.type == "cpu":
        return cloud_aggregate_plain(x, w)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if out.numel():
        _launch("cloud_aggregate", x.data_ptr(), w.data_ptr(),
                out.data_ptr(), x.shape[0], x.shape[1],
                int(x.dtype == torch.bfloat16), x.device.index or 0,
                torch.cuda.current_stream(x.device).cuda_stream)
    return out


def segment_sum_slices(n_rows: int, n_cols: int):
    """``(slices, rows per slice)`` that ``segment_sum`` splits the rows
    into: enough slices for about ``BLOCKS_PER_SM`` blocks per SM with one
    block per column tile and slice, at least ``MIN_SLICE_ROWS`` rows each.
    One slice when the column tiles alone fill the card."""
    tiles = -(-n_cols // TILE)
    slices = max(1, min(-(-BLOCKS_PER_SM * NUM_SMS // tiles),
                        n_rows // MIN_SLICE_ROWS))
    rows = -(-n_rows // slices)
    rows = -(-rows // ROWS) * ROWS
    return -(-n_rows // rows), rows


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
        slices, rows = segment_sum_slices(*x.shape)
        partial = (torch.empty((slices,) + shape, dtype=torch.float32,
                               device=x.device) if slices > 1 else None)
        _launch("segment_sum", x.data_ptr(), w.data_ptr(),
                group_ids.data_ptr(), out.data_ptr(),
                None if partial is None else partial.data_ptr(),
                x.shape[0], x.shape[1], num_groups, rows, slices,
                int(x.dtype == torch.bfloat16), x.device.index or 0,
                torch.cuda.current_stream(x.device).cuda_stream)
    return out
