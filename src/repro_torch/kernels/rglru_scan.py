"""The RG-LRU linear recurrence ``h_t = a_t h_{t-1} + b_t`` (``h_{-1} = 0``)
over ``(B, S, D)``: the wrapper of the CUDA kernel ``csrc/rglru_scan.cu``
and its plain version.  Replaces the TPU kernel ``rglru_scan_blocked``
(``repro/kernels/rglru_scan.py:41``, wrapper ``repro/kernels/ops.py:87``).

A wrapper takes the plain PyTorch version only for a tensor on the CPU.
For a CUDA tensor it launches its kernel on the current stream or raises;
it never falls back.  The kernel has no backward: on the card the wrapper
raises on inputs that require grad and under ``torch.func`` transforms
(``grad_guard``).  ``launch_counts`` (held by ``repro_torch.tracing``'s
registry) counts the launches, so a run can show that its RG-LRU layers
went through the kernel; each launch also hands its cost
(``rglru_scan_cost``) to the running cost walks (``kernels.costs``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import tracing
from repro_torch.kernels import build, costs
from repro_torch.kernels.grad_guard import refuse_autograd
from repro_torch.launch.mesh import NUM_SMS

TILE = 128                     # channels per block, as in csrc/rglru_scan.cu
#: ``rglru_scan`` splits the sequence into chunks until about this many
#: threads (one per (batch, chunk, channel)) are in flight: a full H100
#: (2,048 resident threads per SM) ...
TARGET_THREADS = NUM_SMS * 2048
#: ... with chunks of at least this many steps.
MIN_CHUNK = 64
MAX_GRID_YZ = 65535            # CUDA's limit on grid.y and grid.z

launch_counts = tracing.launch_counts("rglru_scan")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _INT, _INT, _INT,
             _P]


def scan_chunks(batch: int, seq: int, channels: int) -> int:
    """How many chunks ``rglru_scan`` splits the sequence into: enough for
    about ``TARGET_THREADS`` threads, each chunk at least ``MIN_CHUNK``
    steps; one when the (batch, channel) threads alone fill the card."""
    want = -(-TARGET_THREADS // max(batch * channels, 1))
    return max(1, min(want, seq // MIN_CHUNK, MAX_GRID_YZ))


def rglru_scan_plain(a, b):
    """Plain PyTorch version: a log-depth (Hillis-Steele) scan of the
    affine maps ``h -> a_t h + b_t``, in fp32.  a, b: (B, S, D)."""
    a = a.float()
    h = b.float()
    off = 1
    while off < a.shape[1]:
        h = torch.cat([h[:, :off], torch.addcmul(h[:, off:], a[:, off:],
                                                 h[:, :-off])], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return h


def rglru_scan_cost(a, b):
    """(FLOPs, bytes) of one ``rglru_scan`` launch: a multiply and an add a
    step of each channel; a and b read once, the fp32 h written once."""
    return 2 * a.numel(), a.numel() * (a.element_size() + b.element_size()
                                       + 4)


def rglru_scan(a, b):
    """``h_t = a_t h_{t-1} + b_t`` with ``h_{-1} = 0``.  a, b: (B, S, D)
    fp32 or bf16, same dtype and device -> (B, S, D) fp32.  The kernel
    cuts the sequence into ``scan_chunks(B, S, D)`` chunks."""
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"a and b must be (B, S, D) of one shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype not in (torch.float32, torch.bfloat16) or b.dtype != a.dtype:
        raise TypeError(f"a and b must both be float32 or bfloat16, got "
                        f"{a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    refuse_autograd("rglru_scan", a, b)
    if costs.is_fake(a):
        return costs.fake_launch("rglru_scan", rglru_scan_cost,
                                 torch.empty(a.shape, dtype=torch.float32,
                                             device=a.device), a, b)
    for name, t in (("a", a), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_b, n_s, n_d = a.shape
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    if n_b > MAX_GRID_YZ:
        raise ValueError(f"batch {n_b} > {MAX_GRID_YZ}")
    c = scan_chunks(n_b, n_s, n_d)
    if not 1 <= c <= min(n_s, MAX_GRID_YZ):
        raise ValueError(f"chunks must be in [1, {min(n_s, MAX_GRID_YZ)}], "
                         f"got {c}")
    chunk_len = -(-n_s // c)
    c = -(-n_s // chunk_len)
    carry = (torch.empty((2, n_b, c, n_d), dtype=torch.float32,
                         device=a.device) if c > 1 else None)
    err = build.load("rglru_scan", _ARGTYPES)(
        a.data_ptr(), b.data_ptr(), out.data_ptr(),
        None if carry is None else carry.data_ptr(),
        None if carry is None else carry[1].data_ptr(),
        n_b, n_s, n_d, chunk_len, c, int(a.dtype == torch.bfloat16),
        a.device.index or 0, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{err}")
    launch_counts["rglru_scan"] += 1
    costs.record("rglru_scan", rglru_scan_cost, a, b)
    return out
