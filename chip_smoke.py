#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py
(``python3 chip_smoke.py --time-aggregation`` times only
``segment_aggregate``, ``cloud_aggregate``, ``weighted_mean`` and
``segment_sum`` and runs phase 6, through the wrappers alone: copied into
an older tree, it times that tree's kernels, so two trees compare on one
card in one call.)

Phases, in order; any failure ends the run with a non-zero exit:

1. Device: the card's name and power limit, the CUDA kernels built from
   ``src/repro_torch/kernels/csrc`` (build seconds; ptxas's registers and
   spills of every kernel; no spill in ``flash_attention``,
   ``decode_attention``, ``segment_sum``, ``segment_aggregate``,
   ``cloud_aggregate`` and ``weighted_mean``), TF32 off.
2. Kernels against their plain PyTorch versions on the card, at the
   paths' shapes and at the edge cases; each kernel timed (CUDA events,
   median of 100 launches, L2 flushed before each) beside its plain
   version, one PyTorch library call (where one computes the same
   function) and its bound.  The four aggregation kernels also bit for
   bit between two launches (``segment_sum``: the chunk sum formed first,
   then added), on row views from an odd row, one kernel a call at every
   case's shape (``torch.profiler``); ``segment_aggregate`` and
   ``cloud_aggregate`` at phases 3 and 5's cohort (with each wrapper's
   host time a call and one call's device time, and with half and twice
   the warps rule's choice), ``segment_aggregate`` also at phase 9's
   slab, ``cloud_aggregate`` with all-zero weights (NaN, as the
   reference), ``segment_sum`` at the streaming chunk and the LeNet cohort
   (and with half and twice its rule's row slices).
   ``flash_attention`` at the prefill shapes of
   phases 7 and 8 and of the serving CLI (beside masked SDPA, SDPA with
   ``is_causal=True`` and with ``enable_gqa=True`` where there is no window;
   with every warps-per-block count, its rule's among them; its build must
   show no register spill),
   ``decode_attention`` at the decode shapes of phases 7 and 8 and of
   the serving CLI (beside masked SDPA on expanded heads and with
   ``enable_gqa=True``; with half and twice its rule's split count),
   ``weighted_mean`` at phase 9's
   slab and at a fleet-scale shard in fp32 and bf16, its tile counters
   back at 0 after every call (and the slab and the fleet shards with half
   and twice its plan's row slices and other splits).
3. The main path at full width: ``plan()`` on the paper's 5-edge,
   100-UE topology, then synchronous Algorithm 1 on full LeNet
   (``HFLSimulator(device="cuda")``) for 2 cloud rounds; each kernel's
   launch count over exactly that run must equal what the schedule needs.
   Then one warm round timed and one profiled (where the device time goes).
4. The card against the CPU: one cloud round from the same init on both.
5. Async Algorithm 1 at full width (``mode="async"``, ``max_staleness=2``)
   for 2 rounds' delivery quota; launch counts against the departure waves
   of its event trace.  Then the ``max_staleness=0`` barrier against the
   card's sync round of phase 4, within phase 4's rule.
6. Streaming edge aggregation at the largest fleet of
   ``benchmarks/bench_scale.py``: 1,048,576 client rows x 1,024 columns
   folded in 8,192-row chunks made on the card (the 4 GiB buffer never
   exists), one ``segment_sum`` launch per chunk, against a float64
   accumulation of the same chunks; then 10 chunks profiled:
   ``segment_sum``'s device time on the path.
7. Serving at full width: RecurrentGemma-9B (38 layers, 8,532,381,696
   fp32 parameters from seed 0) through ``repro_torch.launch.serve``,
   B=2, a 4,096-token prompt (twice the 2,048 window) and 32 greedy
   tokens; then the same model step by step: 12 ``flash_attention`` and
   26 ``rglru_scan`` launches in prefill, 12 ``decode_attention`` launches
   per decode step; a profiled prefill and decode step (device time and
   kernel count by kernel); the kernel route
   against the plain route (``impl="naive"``) on prefill and
   teacher-forced decode logits, within a multiple of the plain route's
   spread under a 1e-7 perturbation of the embedding; one pattern cycle
   (3 layers) at B=1, S=2,560 on the card against the CPU, prefill and 4
   teacher-forced decode steps.
8. Serving the homogeneous dense stack (the ``"scanned"`` layout) at full
   width: ChatGLM3-6B (28 layers, 6,243,454,976 fp32 parameters from seed
   0), B=2, a 4,096-token prompt and 32 greedy tokens, as phase 7: 28
   ``flash_attention`` launches in prefill and 28 ``decode_attention``
   launches per decode step; 3 layers at B=1, S=320 on the card against
   the CPU.  Then the serving CLI with no arguments: its default,
   StableLM-1.6B (1,644,267,520 parameters), B=4, a 64-token prompt, 32
   tokens.
9. Data-sharded synchronous Algorithm 1: two ``torch.distributed`` ranks
   (gloo, both on the one card; ``run_ranks``) on a 2 x 1 mesh, each
   holding the UE rows of whole edges, run phase 3's problem and model for
   ROUNDS rounds: ``b*`` ``segment_aggregate`` and one ``weighted_mean``
   launch per rank per round, no ``cloud_aggregate``; held to phase 3's
   run repeated unsharded, within SENSITIVITY_FACTOR times the spread of
   that run under a 1e-7 init move (the largest of three moves), and its
   accuracy within one test sample, all with cuDNN's deterministic
   algorithms (with its default ones a LeNet run on the card differs from
   itself as much as the sharded run differs from it).  Then one sharded cloud event at fleet scale,
   2 ranks x 16,384 UE rows x 44,426 fp32 columns made on the card,
   against a float64 sum and all-reduce.
10. Kernel records as JSON (``launches``: each path's count, read around
   its run with the counts reset just before it, summed over the paths
   and, in phase 9, over the ranks), then the result line.

Needs one CUDA card, ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``) and
``nvidia-smi``.  Without a card it exits 1 before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.lenet_mnist import LeNetConfig  # noqa: E402
from repro_torch.core import HFLProblem, plan  # noqa: E402
from repro_torch.data import (TokenStream, size_partition,  # noqa: E402
                              synthetic_mnist)
from repro_torch.fl.aggregate import (StreamingEdgeAccumulator,  # noqa: E402
                                      flat_cloud_aggregate)
from repro_torch.fl.flatten import tree_leaves  # noqa: E402
from repro_torch.fl.sim import HFLSimulator  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import hier_aggregate as ha  # noqa: E402
from repro_torch.kernels import rglru_scan as rs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import make_agg_mesh, run_ranks  # noqa: E402
from repro_torch.models.lenet import lenet_init, lenet_loss  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM rate and fp32 (non-tensor-core)
# rate, for the bound of each kernel.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

MAIN = dict(num_edges=5, num_ues=100, epsilon=0.25, seed=0)
ROUNDS = 2
SAMPLES_PER_UE = 64
LR = 0.05
KERNEL_RTOL = 1e-5           # of the result's largest magnitude: the kernel
                             # and its plain version sum in other orders
# Phase 4 tolerance.  136 GD steps through tanh convolutions amplify
# float32 rounding far past any fixed 1e-5: moving the init by 1e-7
# relative moves the result by ~5e-4 (phase 4 prints it).  The card
# differs from the CPU only in the order of its sums, so its result must
# lie within 10x the CPU's own spread under such a perturbation, measured
# in the same run.
SENSITIVITY_NOISE = 1e-7
SENSITIVITY_FACTOR = 10.0
ASYNC_STALENESS = 2
# Phase 6: benchmarks/bench_scale.py's largest fleet and its chunking.
STREAM_ROWS = 1 << 20
STREAM_COLS = 1024
STREAM_GROUPS = 16
STREAM_CHUNK = 8192
STREAM_SEED = 7
STREAM_RTOL = 1e-5           # of the largest |mean|: fp32 chunk sums added
                             # 128 times, against a float64 accumulation

# Phase 7: full-width RecurrentGemma-9B serving.
SERVE_ARCH = "recurrentgemma-9b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 2, 4096, 32
SERVE_PARAMS = 8_532_381_696
CPU_BATCH, CPU_PROMPT = 1, 2560   # one pattern cycle, card against the CPU
CPU_STEPS = 4                     # teacher-forced decode steps, card vs CPU
# The kernel route against the plain route (and the card against the CPU)
# is held, as phase 4 holds LeNet, to SENSITIVITY_FACTOR times the plain
# route's own spread when the embedding moves by 1e-7 relative
# (SENSITIVITY_NOISE), measured in the same run.  The two routes differ
# only in the order of their sums; a masking or indexing fault moves the
# logits by percents of their scale, orders of magnitude past that.
ATTN_ATOL = 2e-5             # tests/test_kernels.py's attention tolerance
FA_INSTANTIATIONS = 6        # flash_attention.cu: head dims 64/128/256 x
                             # fp32/bf16
DA_INSTANTIATIONS = 12       # decode_attention.cu: head dims 64/128/256 x
                             # 1 or 2 m-tiles x fp32/bf16
SEG_INSTANTIATIONS = 6       # segment_sum.cu, segment_aggregate.cu,
                             # cloud_aggregate.cu, weighted_mean.cu: load
                             # widths of 4, 2, 1 elements x fp32/bf16
HOST_CALLS = 1000            # calls timed on the host clock, no sync
# Phase 8: full-width ChatGLM3-6B serving (B, prompt and tokens as phase
# 7), and the serving CLI's default model at the CLI's default sizes.
GLM_ARCH = "chatglm3-6b"
GLM_PARAMS = 6_243_454_976
GLM_CPU_PROMPT = 320
CLI_ARCH = "stablelm-1.6b"
CLI_PARAMS = 1_644_267_520
CLI_BATCH, CLI_PROMPT, CLI_LAYERS = 4, 64, 24
# Phase 9: two data shards of phase 3's fleet (5 edges of 20 UEs packed
# 3 + 2: 60 rows a shard, 20 of them padding on the second), then a
# fleet-scale shard per rank.
SHARD_RANKS = 2
SHARD_ROWS = 60
SPREAD_SEEDS = (1, 2, 3)
LENET_PARAMS = 44_426
FLEET_ROWS = 16_384
FLEET_SEED = 11
RANK_TIMEOUT_S = 480

KERNELS = {
    "segment_aggregate": dict(
        source="src/repro_torch/kernels/csrc/segment_aggregate.cu",
        replaces="src/repro/kernels/hier_aggregate.py:182"),
    "cloud_aggregate": dict(
        source="src/repro_torch/kernels/csrc/cloud_aggregate.cu",
        replaces="src/repro/kernels/hier_aggregate.py:117"),
    "weighted_mean": dict(
        source="src/repro_torch/kernels/csrc/weighted_mean.cu",
        replaces="src/repro/kernels/hier_aggregate.py:62"),
    "segment_sum": dict(
        source="src/repro_torch/kernels/csrc/segment_sum.cu",
        replaces="src/repro/kernels/hier_aggregate.py:263"),
    "flash_attention": dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:89"),
    "rglru_scan": dict(
        source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:41"),
    "decode_attention": dict(
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:66"),
}
COUNTERS = (ha, fa, rs, da)


def reset_counts() -> None:
    for mod in COUNTERS:
        mod.reset_launch_counts()


def counts() -> dict:
    out = {}
    for mod in COUNTERS:
        out.update(mod.launch_counts)
    return out


def expect(**launched) -> dict:
    """Every kernel's count: ``launched`` where named, else 0."""
    return {name: launched.get(name, 0) for name in KERNELS}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


# ---------------------------------------------------------------------------
# Phase 1
# ---------------------------------------------------------------------------


def phase_device() -> None:
    t0 = time.perf_counter()
    paths = build.build()
    print(f"built {', '.join(paths)} in {time.perf_counter() - t0:.2f} s")
    for name, path in paths.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    check_no_spill(paths["flash_attention"], FA_INSTANTIATIONS)
    check_no_spill(paths["decode_attention"], DA_INSTANTIATIONS)
    check_no_spill(paths["segment_sum"], SEG_INSTANTIATIONS)
    check_no_spill(paths["segment_aggregate"], SEG_INSTANTIATIONS)
    check_no_spill(paths["cloud_aggregate"], SEG_INSTANTIATIONS)
    check_no_spill(paths["weighted_mean"], SEG_INSTANTIATIONS)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off: cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False")


def check_no_spill(path, instantiations: int) -> None:
    """Every kernel of the library at ``path`` compiled without spilling:
    ptxas (``-Xptxas -v``) reports 0 bytes of spill stores and loads for
    each of its ``instantiations``."""
    lines = [ln.strip() for ln in path.with_suffix(".log").read_text()
             .splitlines() if "spill" in ln]
    name = path.name.split("-")[0]
    check(len(lines) >= instantiations, f"{path.name}: {len(lines)} "
          f"ptxas spill lines, expected {instantiations}")
    spilled = [ln for ln in lines
               if "0 bytes spill stores, 0 bytes spill loads" not in ln]
    check(not spilled, f"{path.name} spills: {spilled}")
    print(f"  {name}: ptxas reports no spill in any of its {len(lines)} "
          f"kernels")


# ---------------------------------------------------------------------------
# Phase 2
# ---------------------------------------------------------------------------


def kernel_cases(device):
    """name -> (x, w, group_ids, num_groups), made from a seed on ``device``:
    the main path's shape, then the edge cases."""
    rng = np.random.default_rng(0)
    cases = {}
    for name, n, f, m, edit in [
            ("main_n100_f44426", 100, 44_426, 5, None),
            ("slab_n60_f44426", SHARD_ROWS, LENET_PARAMS, 5, None),
            ("past_tpu_split_n1000", 1000, 1000, 5, None),
            ("ragged_f1001", 100, 1001, 5, None),
            ("bf16_main", 100, 44_426, 5, "bf16"),
            ("edge_without_members", 100, 1001, 6, "empty"),
            ("edge_all_zero_weight", 100, 1001, 5, "zero"),
            ("odd_row_view_f44426", 100, 44_426, 5, "odd_row"),
            ("bf16_odd_row_view", 100, 44_426, 5, "bf16_odd_row")]:
        odd = bool(edit) and "odd_row" in edit
        x = torch.from_numpy(rng.normal(0, 1, (n + odd, f)).astype(np.float32))
        w = torch.from_numpy(rng.uniform(200, 1000, n).astype(np.float32))
        g = torch.from_numpy((np.arange(n) % min(m, 5)).astype(np.int32))
        if edit in ("bf16", "bf16_odd_row"):
            x = x.to(torch.bfloat16)
        if edit == "zero":
            w[g == 2] = 0.0
        # a row view from row 1 of the buffer: 8-byte (fp32) or 4-byte
        # (bf16) aligned at F = 44,426, as a shard's slab can be
        x = x.to(device)[1:] if odd else x.to(device)
        cases[name] = (x, w.to(device), g.to(device), m)
    return cases


def _max_err(out, ref) -> float:
    return float((out - ref).abs().max())


def check_kernels_against_plain(cases) -> dict:
    """Each kernel on each case against its plain version; returns the
    largest absolute error per kernel."""
    errs = {"segment_aggregate": 0.0, "cloud_aggregate": 0.0}
    for case, (x, w, g, m) in cases.items():
        pairs = {
            "segment_aggregate": (ha.segment_aggregate(x, w, g, m),
                                  ha.segment_aggregate_plain(x, w, g, m)),
            "cloud_aggregate": (ha.cloud_aggregate(x, w),
                                ha.cloud_aggregate_plain(x, w)),
        }
        again = {"segment_aggregate": ha.segment_aggregate(x, w, g, m),
                 "cloud_aggregate": ha.cloud_aggregate(x, w)}
        torch.cuda.synchronize()
        for name, out in again.items():
            check(torch.equal(pairs[name][0], out),
                  f"{name} on {case}: two launches differ")
        for name, (out, ref) in pairs.items():
            check(out.dtype == torch.float32 and out.shape == x.shape,
                  f"{name} on {case}: dtype/shape")
            check(bool(torch.isfinite(out).all()), f"{name} on {case}: finite")
            err = _max_err(out, ref)
            scale = float(ref.abs().max())
            check(err <= KERNEL_RTOL * scale,
                  f"{name} on {case}: max|err| {err:.3e} > "
                  f"{KERNEL_RTOL} x {scale:.3e}")
            errs[name] = max(errs[name], err)
            print(f"  {name:17s} {case:22s} max|err| {err:.3e} "
                  f"(scale {scale:.3e})")
        if case == "edge_all_zero_weight":
            seg = pairs["segment_aggregate"][0]
            check(bool((seg[g == 2] == 0).all()),
                  "segment_aggregate: all-zero-weight edge is not exactly 0")
            print("  segment_aggregate  all-zero-weight edge gives exactly 0")
    # No guard in eq. 10: all-zero weights give NaN at every N, as the
    # reference's plain route (the TPU kernel's fall-through for N > 512
    # to the guarded segment kernel is not followed).
    for n in (40, 600):
        x = cases["past_tpu_split_n1000"][0][:n]
        w = torch.zeros(n, device="cuda")
        check(bool(ha.cloud_aggregate(x, w).isnan().all()
                   and ha.cloud_aggregate_plain(x, w).isnan().all()),
              f"cloud_aggregate: all-zero weights at N={n} do not give NaN")
    print("  cloud_aggregate    all-zero weights give NaN at N=40 and 600, "
          "as the reference")
    return errs


def time_ms(fn, flush: torch.Tensor, iters: int = 100,
            warmup: int = 10) -> float:
    """Median device time of ``fn`` in ms over ``iters`` launches, each
    bracketed by CUDA events, with the L2 cache flushed before each (the
    flush also keeps the stream busy while the host enqueues ``fn``)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def averaging_operator(w, g, m):
    """(N, N) matrix P with P @ x equal to the eq. 6 (``g`` given) or eq. 10
    (``g`` None) event: one ``torch.mm`` is then the library yardstick."""
    if g is None:
        return (w / w.sum())[None, :].expand(w.shape[0], -1).contiguous()
    same = (g[:, None] == g[None, :]).to(torch.float32)
    gw = torch.zeros(m, device=w.device).index_add_(0, g.long(), w)
    return same * w[None, :] / gw.clamp_min(1e-12)[g.long()][:, None]


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host microseconds per call of ``fn``: a loop of ``calls`` calls with
    no synchronisation between them (the card runs behind the host)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    per_call = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return per_call


def kernels_per_call(fn, flush: torch.Tensor) -> dict:
    """The device kernels one call of ``fn`` launches, the L2 flushed just
    before (``torch.profiler``): name -> (count, device us)."""
    fn()
    flush.zero_()
    torch.cuda.synchronize()
    return {e.key: (e.count, e.self_device_time_total)
            for e in device_profile(fn)[1]}


def launched_line(launched: dict) -> str:
    return "; ".join(f"{k.split('(')[0][-40:]} {c}x {us:.2f} us"
                     for k, (c, us) in launched.items())


def aggregation_calls(cases, s_cases) -> dict:
    """name -> one call of ``segment_aggregate``, ``cloud_aggregate`` or
    ``segment_sum`` (adding into an accumulator, as the streaming path
    calls it) at each case's shape."""
    accs = {case: torch.zeros(m, x.shape[1], device=x.device)
            for case, (x, _, _, m) in s_cases.items()}
    return {
        "segment_aggregate": [
            lambda x=x, w=w, g=g, m=m: ha.segment_aggregate(x, w, g, m)
            for x, w, g, m in cases.values()],
        "cloud_aggregate": [lambda x=x, w=w: ha.cloud_aggregate(x, w)
                            for x, w, _, _ in cases.values()],
        "segment_sum": [
            lambda x=x, w=w, g=g, m=m, acc=accs[case]:
            ha.segment_sum(x, w, g, m, out=acc)
            for case, (x, w, g, m) in s_cases.items()]}


def check_one_launch(calls_by_name: dict) -> None:
    """The calls of each wrapper (name -> calls), one ``torch.profiler``
    session a wrapper: only that wrapper's kernel runs, at most once a
    call (the profiler may drop a record)."""
    flush = torch.empty(256 * 2**20 // 4, device="cuda")
    for name, calls in calls_by_name.items():
        launched = kernels_per_call(lambda: [fn() for fn in calls], flush)
        count = sum(c for c, _ in launched.values())
        check(bool(launched) and all(f"{name}_kernel" in k for k in launched)
              and count <= len(calls), f"{name}: {len(calls)} calls "
              f"launched {launched}")
        print(f"  {name}: {len(calls)} calls, one at each case's shape, "
              f"launched {count} kernels, all {name}_kernel")


def time_kernels(x, w, g, m,
                 names=("segment_aggregate", "cloud_aggregate")) -> dict:
    """Kernel, plain-version and library times of the events ``names`` on
    one input, the wrappers' host time per call, and each kernel's bound
    from this input's bytes and operations."""
    flush = torch.empty(256 * 2**20 // 4, device=x.device)   # > 50 MB L2
    n, f = x.shape
    ops = {"segment_aggregate": (ha.segment_aggregate, ha.segment_aggregate_plain,
                                 (w, g, m), 2),
           "cloud_aggregate": (ha.cloud_aggregate, ha.cloud_aggregate_plain,
                               (w,), 1)}
    out = {}
    for name in names:
        kernel, plain, args, side_inputs = ops[name]
        p = averaging_operator(w, g if side_inputs == 2 else None, m)
        ref = plain(x, *args)
        check(_max_err(torch.mm(p, x), ref)
              <= KERNEL_RTOL * float(ref.abs().max()),
              "torch.mm with the averaging operator computes the event")
        nbytes = n * f * x.element_size() + n * f * 4 + side_inputs * n * 4
        launched = kernels_per_call(lambda: kernel(x, *args), flush)
        out[name] = dict(
            ms=time_ms(lambda: kernel(x, *args), flush),
            plain_ms=time_ms(lambda: plain(x, *args), flush),
            library_ms=time_ms(lambda: torch.mm(p, x), flush),
            **bound(nbytes, 2 * n * f))
        r = out[name]
        print(f"  {name:17s} N={n} F={f} M={m}: kernel "
              f"{r['ms'] * 1e3:8.2f} us   plain {r['plain_ms'] * 1e3:8.2f} us"
              f"   torch.mm {r['library_ms'] * 1e3:8.2f} us   bound "
              f"{r['bound_ms'] * 1e3:6.2f} us ({r['bound_by']}, {nbytes} B);"
              f" host {host_us(lambda: kernel(x, *args)):.2f} us a call; "
              f"one call profiled: {launched_line(launched)}")
    return out


def sum_cases(device):
    """name -> (x, w, group_ids, num_groups) for ``segment_sum``, made from
    a seed on ``device``: the streaming chunk and the LeNet cohort shapes,
    then the edge cases."""
    rng = np.random.default_rng(1)
    cases = {}
    for name, n, f, m, edit in [
            ("stream_n8192_f1024", STREAM_CHUNK, STREAM_COLS, STREAM_GROUPS,
             None),
            ("lenet_n100_f44426", 100, 44_426, 5, None),
            ("chunk_of_1", 1, STREAM_COLS, STREAM_GROUPS, None),
            ("chunk_of_7", 7, STREAM_COLS, STREAM_GROUPS, None),
            ("ragged_f1001", STREAM_CHUNK, 1001, STREAM_GROUPS, None),
            ("bf16_stream", STREAM_CHUNK, STREAM_COLS, STREAM_GROUPS, "bf16"),
            ("group_without_members", 1000, 1001, 6, "empty"),
            ("group_all_zero_weight", 1000, 1001, 5, "zero"),
            ("max_groups", 2000, 1001, ha.MAX_GROUPS, None),
            ("odd_row_view_f44426", 100, 44_426, 5, "odd_row"),
            ("bf16_odd_row_view", 100, 44_426, 5, "bf16_odd_row")]:
        odd = bool(edit) and "odd_row" in edit
        x = torch.from_numpy(rng.normal(0, 1, (n + odd, f)).astype(np.float32))
        w = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32))
        g = torch.from_numpy(rng.integers(0, m, n).astype(np.int32))
        if edit in ("bf16", "bf16_odd_row"):
            x = x.to(torch.bfloat16)
        if edit == "empty":
            g = torch.from_numpy((np.arange(n) % (m - 1)).astype(np.int32))
        if edit == "zero":
            w[g == 2] = 0.0
        x = x.to(device)[1:] if odd else x.to(device)
        cases[name] = (x, w.to(device), g.to(device), m)
    return cases


def check_segment_sum_against_plain(cases) -> float:
    """``segment_sum`` on each case against its plain version, bit for bit
    between two launches, the chunk sum formed first and then added
    (``0.5 + sum`` exactly), and exact zeros for a group without members
    or with only zero weights; returns the largest absolute error."""
    worst = 0.0
    for case, (x, w, g, m) in cases.items():
        out = ha.segment_sum(x, w, g, m)
        again = ha.segment_sum(x, w, g, m)
        acc = ha.segment_sum(x, w, g, m, out=torch.full_like(out, 0.5))
        ref = ha.segment_sum_plain(x, w, g, m)
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"segment_sum on {case}: two "
              "launches differ")
        check(torch.equal(acc, 0.5 + out), f"segment_sum on {case}: the "
              "chunk sum is not formed first and then added")
        check(out.dtype == torch.float32 and tuple(out.shape) ==
              (m, x.shape[1]), f"segment_sum on {case}: dtype/shape")
        check(bool(torch.isfinite(out).all()), f"segment_sum on {case}: "
              "finite")
        err = _max_err(out, ref)
        scale = float(ref.abs().max())
        check(err <= KERNEL_RTOL * scale,
              f"segment_sum on {case}: max|err| {err:.3e} > "
              f"{KERNEL_RTOL} x {scale:.3e}")
        worst = max(worst, err)
        slices, _, warps = ha.segment_sum_plan(*x.shape, m)
        print(f"  {'segment_sum':17s} {case:22s} max|err| {err:.3e} "
              f"(scale {scale:.3e}; {slices} row slices, {warps} warps a "
              f"block, loads of {ha.load_width(x.shape[1], x.element_size(), x.data_ptr())})")
        zero = {"group_without_members": m - 1,
                "group_all_zero_weight": 2}.get(case)
        if zero is not None:
            check(bool((out[zero] == 0).all()),
                  f"segment_sum on {case}: group {zero} is not exactly 0")
            print(f"  {'segment_sum':17s} {case:22s} group {zero} gives "
                  "exactly 0")
    return worst


def time_segment_sum(x, w, g, m) -> dict:
    """``segment_sum`` as the accumulator calls it (adding into an (M, F)
    accumulator), its plain version and the library yardstick: one
    ``torch.mm`` of the (M, N) weighted one-hot with the chunk; the
    wrapper's host time per call and the kernels one call launches."""
    flush = torch.empty(256 * 2**20 // 4, device=x.device)   # > 50 MB L2
    n, f = x.shape
    acc = torch.zeros(m, f, device=x.device)
    onehot = torch.zeros(m, n, device=x.device)
    onehot[g.long(), torch.arange(n, device=x.device)] = w
    ref = ha.segment_sum_plain(x, w, g, m)
    check(_max_err(torch.mm(onehot, x), ref)
          <= KERNEL_RTOL * float(ref.abs().max()),
          "torch.mm with the weighted one-hot computes segment_sum")
    nbytes = (n * f * x.element_size() + 2 * n * 4   # chunk, w, group ids
              + 2 * m * f * 4)                       # accumulator in and out
    launched = kernels_per_call(lambda: ha.segment_sum(x, w, g, m, out=acc),
                                flush)
    r = dict(ms=time_ms(lambda: ha.segment_sum(x, w, g, m, out=acc), flush),
             plain_ms=time_ms(lambda: ha.segment_sum_plain(x, w, g, m),
                              flush),
             library_ms=time_ms(lambda: torch.mm(onehot, x), flush),
             **bound(nbytes, 2 * n * f))
    print(f"  {'segment_sum':17s} N={n} F={f} M={m}: kernel "
          f"{r['ms'] * 1e3:8.2f} us   plain {r['plain_ms'] * 1e3:8.2f} us"
          f"   torch.mm {r['library_ms'] * 1e3:8.2f} us   bound "
          f"{r['bound_ms'] * 1e3:6.2f} us ({r['bound_by']}, {nbytes} B); "
          f"host {host_us(lambda: ha.segment_sum(x, w, g, m, out=acc)):.2f}"
          f" us a call; one call profiled: {launched_line(launched)}")
    return r


def time_slice_rule(x, w, g, m) -> None:
    """``segment_sum`` with the row slices its rule picks
    (``hier_aggregate.segment_sum_plan``: about a block per SM) against
    half and twice as many, on the same inputs, so that the rule is
    checked on every run."""
    flush = torch.empty(256 * 2**20 // 4, device=x.device)
    acc = torch.zeros(m, x.shape[1], device=x.device)
    n = x.shape[0]
    chosen = ha.segment_sum_plan(*x.shape, m)[0]
    times = []
    for slices in (max(1, chosen // 2), chosen, 2 * chosen):
        rows = -(-n // slices)
        slices = -(-n // rows)
        plan = (slices, rows, ha.block_warps(
            rows, slices * -(-x.shape[1] // ha.TILE), m * ha.TILE))
        with mock.patch.object(ha, "segment_sum_plan", lambda *_: plan):
            times.append((plan, time_ms(
                lambda: ha.segment_sum(x, w, g, m, out=acc), flush)))
    print("  segment_sum       slices: " + ", ".join(
        f"{s} of {r} rows, {k} warps -> {t * 1e3:.2f} us"
        for (s, r, k), t in times) + f" (the rule picks {chosen})")


def time_aggregate_warps_rule(x, w, g, m, name="segment_aggregate") -> None:
    """``segment_aggregate`` (or ``cloud_aggregate``) with the warps a
    block its rule picks (``hier_aggregate.segment_aggregate_warps`` or
    ``cloud_aggregate_warps``) against half and twice as many, on the same
    inputs."""
    flush = torch.empty(256 * 2**20 // 4, device=x.device)
    if name == "segment_aggregate":
        chosen = ha.segment_aggregate_warps(*x.shape, m)
        call = lambda: ha.segment_aggregate(x, w, g, m)  # noqa: E731
    else:
        chosen = ha.cloud_aggregate_warps(*x.shape)
        call = lambda: ha.cloud_aggregate(x, w)  # noqa: E731
    times = []
    for warps in sorted({max(1, chosen // 2), chosen,
                         min(ha.MAX_WARPS, 2 * chosen)}):
        with mock.patch.object(ha, f"{name}_warps", lambda *_: warps):
            times.append((warps, time_ms(call, flush)))
    print(f"  {name} N={x.shape[0]} warps: " + ", ".join(
        f"{k} -> {t * 1e3:.2f} us" for k, t in times)
        + f" (the rule picks {chosen})")


def fleet_shard(rank: int):
    """Rank ``rank``'s fleet-scale shard (FLEET_ROWS x LENET_PARAMS fp32)
    and its weights in [0.5, 2), made on the card from a generator keyed
    by (FLEET_SEED, rank)."""
    seed = int(np.random.SeedSequence([FLEET_SEED, rank])
               .generate_state(1)[0])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(FLEET_ROWS, LENET_PARAMS, generator=gen, device="cuda")
    w = torch.rand(FLEET_ROWS, generator=gen, device="cuda") * 1.5 + 0.5
    return x, w


def mean_cases():
    """name -> (x, w) for ``weighted_mean`` on the card: phase 9's slab,
    the edge cases (row views from an odd row among them), then a
    fleet-scale shard in fp32 and bf16."""
    rng = np.random.default_rng(2)
    cases = {}
    for name, n, f, edit in [
            ("slab_n60_f44426", SHARD_ROWS, LENET_PARAMS, None),
            ("one_row", 1, 1001, None),
            ("n513_past_tpu_split", 513, 1001, None),
            ("ragged_n1030_f1001", 1030, 1001, None),
            ("one_nonzero_weight", 300, 1001, "one"),
            ("all_zero_weights", 40, 300, "zero"),
            ("bf16_n513", 513, 1001, "bf16"),
            ("odd_row_view_f44426", 100, 44_426, "odd_row"),
            ("bf16_odd_row_view", 100, 44_426, "bf16_odd_row")]:
        odd = bool(edit) and "odd_row" in edit
        x = torch.from_numpy(rng.normal(0, 1, (n + odd, f))
                             .astype(np.float32))
        w = torch.from_numpy(rng.uniform(200, 1000, n).astype(np.float32))
        if edit in ("bf16", "bf16_odd_row"):
            x = x.to(torch.bfloat16)
        if edit == "one":
            w[:] = 0.0
            w[n // 2] = 3.0
        if edit == "zero":
            w[:] = 0.0
        # a row view from row 1, as in kernel_cases
        cases[name] = (x.cuda()[1:] if odd else x.cuda(), w.cuda())
    x, w = fleet_shard(0)
    cases["fleet_n16384_f44426"] = (x, w)
    cases["bf16_fleet"] = (x.to(torch.bfloat16), w)
    return cases


def counters_at_zero() -> bool:
    """The tile counters of ``segment_sum`` and ``weighted_mean`` on the
    card (if a launch has made them) are all 0, as every launch leaves
    them."""
    return all(int(c.count_nonzero()) == 0 for c, _ in ha._scratch.values())


def plan_line(x) -> str:
    slices, rows, warps = ha.weighted_mean_plan(*x.shape)
    return f"{slices} row slices of {rows}, {warps} warps a block"


def check_mean_against_plain(cases) -> float:
    """``weighted_mean`` on each case against its plain version, bit for
    bit between two launches, NaN for all-zero weights (0/0, as the
    reference), the tile counters back at 0 after each case; returns the
    largest absolute error."""
    worst = 0.0
    for case, (x, w) in cases.items():
        out = ha.weighted_mean(x, w)
        again = ha.weighted_mean(x, w)
        ref = ha.weighted_mean_plain(x, w)
        torch.cuda.synchronize()
        check(counters_at_zero(), f"weighted_mean on {case}: tile counters "
              "not back at 0")
        check(out.dtype == torch.float32 and tuple(out.shape) ==
              (x.shape[1],), f"weighted_mean on {case}: dtype/shape")
        if case == "all_zero_weights":
            check(bool(out.isnan().all()), "weighted_mean: all-zero weights "
                  "do not give NaN")
            print(f"  {'weighted_mean':17s} {case:22s} gives NaN (0/0), as "
                  "the reference")
            continue
        check(bool(torch.isfinite(out).all()), f"weighted_mean on {case}: "
              "finite")
        check(torch.equal(out, again), f"weighted_mean on {case}: two "
              "launches differ")
        err = _max_err(out, ref)
        scale = float(ref.abs().max())
        check(err <= KERNEL_RTOL * scale, f"weighted_mean on {case}: max|err| "
              f"{err:.3e} > {KERNEL_RTOL} x {scale:.3e}")
        if case == "one_nonzero_weight":
            row = x[x.shape[0] // 2].float()
            check(_max_err(out, row) <= KERNEL_RTOL * scale,
                  "weighted_mean: one nonzero weight gives that row")
        worst = max(worst, err)
        print(f"  {'weighted_mean':17s} {case:22s} max|err| {err:.3e} "
              f"(scale {scale:.3e}; {plan_line(x)}; loads of "
              f"{ha.load_width(x.shape[1], x.element_size(), x.data_ptr())})")
    return worst


def time_mean(x, w, note: str = "") -> dict:
    """``weighted_mean``, its plain version and, for fp32, the library
    yardstick ``torch.mv(x.t(), w) / w.sum()``, and its bound from this
    input's bytes (the slab and w read once, the mean written once) and
    operations; ``note`` is printed after them."""
    flush = torch.empty(256 * 2**20 // 4, device=x.device)   # > 50 MB L2
    n, f = x.shape
    fp32 = x.dtype == torch.float32

    def library():
        return torch.mv(x.t(), w) / w.sum()

    if fp32:
        ref = ha.weighted_mean_plain(x, w)
        check(_max_err(library(), ref) <= KERNEL_RTOL * float(
            ref.abs().max()), "torch.mv computes the weighted mean")
    r = dict(ms=time_ms(lambda: ha.weighted_mean(x, w), flush),
             plain_ms=time_ms(lambda: ha.weighted_mean_plain(x, w), flush),
             library_ms=time_ms(library, flush) if fp32 else None,
             **bound(n * f * x.element_size() + n * 4 + f * 4, 2 * n * f))
    lib = (f"torch.mv {r['library_ms'] * 1e3:9.2f} us" if fp32 else
           "torch.mv (fp32 only)")
    print(f"  {'weighted_mean':17s} N={n} F={f} {str(x.dtype)[6:]}: kernel "
          f"{r['ms'] * 1e3:9.2f} us   plain {r['plain_ms'] * 1e3:9.2f} us   "
          f"{lib}   bound {r['bound_ms'] * 1e3:8.2f} us ({r['bound_by']})"
          f"{note}")
    return r


def time_mean_slice_rule(x, w) -> None:
    """``weighted_mean`` with the split its plan picks
    (``hier_aggregate.weighted_mean_plan``: slices and warps a block)
    against half and twice its slices at its warps, and at 4, 8 and 16
    warps a block against the slices that fill 1, 2, 4, 8 and 16 waves, on
    the same inputs."""
    flush = torch.empty(256 * 2**20 // 4, device=x.device)
    n, f = x.shape
    tiles = -(-f // ha.TILE)
    chosen, _, warps = ha.weighted_mean_plan(n, f)
    splits = {(max(1, chosen // 2), warps), (chosen, warps),
              (2 * chosen, warps)}
    for k in (4, 8, 16):
        wave = ha.NUM_SMS * (ha.ONE_GROUP_RESIDENT_WARPS // k) // tiles
        splits |= {(max(waves, waves * wave), k)
                   for waves in (1, 2, 4, 8, 16)}
    times = []
    for slices, k in sorted(splits, key=lambda s: (s[1], s[0])):
        rows = -(-n // slices)
        plan = (-(-n // rows), rows, k)
        with mock.patch.object(ha, "weighted_mean_plan", lambda *_: plan):
            times.append((plan, time_ms(lambda: ha.weighted_mean(x, w),
                                        flush)))
    print(f"  weighted_mean     N={n} {str(x.dtype)[6:]} splits: " + ", ".join(
        f"{s} x {k} warps -> {t * 1e3:.2f} us" for (s, _, k), t in times)
        + f" (the plan picks {chosen} x {warps} warps)")


# B, Sq, Sk, H, K, hd, causal, window: tests/test_kernels.py's ATTN_CASES,
# then MQA at head_dim 256 under a window, ragged Sq < Sk, a first key tile
# fully masked for most rows of a query tile, two non-causal cases, groups
# of 6 and 16 that do not fill a block's rows evenly, one query row at
# g = 16, head_dim 4, a window under one key tile, and the prefill shapes
# of phases 7 and 8 and of the serving CLI's default run.
ATTN_SERVING = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 16, 1, 256, True,
                2048)
ATTN_GLM = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 32, 2, 128, True, 0)
ATTN_CLI = (CLI_BATCH, CLI_PROMPT, CLI_PROMPT, 32, 32, 64, True, 0)
ATTN_CASES = [
    (2, 128, 128, 8, 4, 64, True, 0),
    (1, 256, 256, 4, 4, 32, True, 64),
    (2, 100, 100, 8, 2, 64, True, 0),
    (1, 1, 384, 8, 8, 64, True, 0),
    (1, 1, 250, 4, 2, 32, True, 0),
    (1, 1, 512, 4, 4, 64, True, 128),
    (2, 64, 64, 8, 1, 128, True, 0),
    (1, 192, 192, 6, 3, 32, True, 48),
    (1, 300, 300, 16, 1, 256, True, 128),
    (2, 77, 333, 4, 2, 32, True, 0),
    (1, 256, 256, 4, 1, 64, True, 40),
    (2, 200, 200, 8, 2, 64, False, 0),
    (1, 70, 300, 4, 1, 100, False, 0),
    (2, 100, 100, 12, 2, 128, True, 0),
    (1, 90, 90, 12, 2, 64, True, 20),
    (1, 50, 300, 16, 1, 128, True, 0),
    (2, 1, 200, 16, 1, 256, True, 64),
    (1, 40, 40, 4, 2, 4, True, 0),
    (1, 200, 200, 8, 2, 64, True, 7),
    ATTN_SERVING,
    ATTN_GLM,
    ATTN_CLI,
]
# B, S, D: tests/test_kernels.py's RGLRU_CASES, then the serving shape
SCAN_SERVING = (SERVE_BATCH, SERVE_PROMPT, 4096)
SCAN_CASES = [(2, 64, 128), (1, 300, 96), (3, 17, 8), (1, 512, 256),
              SCAN_SERVING]
SCAN_RTOL = 1e-5             # of the largest |h|: chunked sequential kernel
                             # against the plain log-depth scan


def attn_inputs(case, dtype=torch.float32):
    B, Sq, Sk, H, K, hd = case[:6]
    gen = torch.Generator(device="cuda").manual_seed(Sq * 7 + Sk + hd)
    return tuple(torch.randn(s, generator=gen, device="cuda").to(dtype)
                 for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd)))


def check_attention_against_plain() -> float:
    """``flash_attention`` on each case against its plain version (fp32
    within ATTN_ATOL; two bf16 cases within 2 bf16 ulps of the largest
    value) and bit for bit between two launches; returns the largest fp32
    absolute error."""
    worst = 0.0
    for case in ATTN_CASES + [(2, 128, 128, 8, 4, 64, True, 0, "bf16"),
                              (1, 300, 300, 16, 1, 256, True, 128, "bf16")]:
        causal, window = case[6], case[7]
        bf16 = case[-1] == "bf16"
        q, k, v = attn_inputs(case, torch.bfloat16 if bf16 else torch.float32)
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        again = fa.flash_attention(q, k, v, causal=causal, window=window)
        ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        check(out.shape == q.shape and out.dtype == q.dtype,
              f"flash_attention {case}: dtype/shape")
        check(bool(torch.isfinite(out).all()), f"flash_attention {case}: "
              "finite")
        check(torch.equal(out, again), f"flash_attention {case}: two "
              "launches differ")
        err = _max_err(out.float(), ref.float())
        scale = float(ref.float().abs().max())
        tol = 2 * 2 ** -8 * scale if bf16 else ATTN_ATOL
        check(err <= tol, f"flash_attention {case}: max|err| {err:.3e} > "
              f"{tol:.3e}")
        if not bf16:
            worst = max(worst, err)
        print(f"  {'flash_attention':17s} {'-'.join(map(str, case)):32s} "
              f"max|err| {err:.3e} (scale {scale:.3e})")
    return worst


def scan_inputs(case):
    gen = torch.Generator(device="cuda").manual_seed(sum(case))
    a = torch.rand(case, generator=gen, device="cuda") * 0.299 + 0.7
    return a, torch.randn(case, generator=gen, device="cuda")


def check_scan_against_plain() -> float:
    """``rglru_scan`` on each case against its plain version, within
    SCAN_RTOL of the largest |h|, and bit for bit between two launches;
    returns the largest absolute error."""
    worst = 0.0
    for case in SCAN_CASES:
        a, b = scan_inputs(case)
        out = rs.rglru_scan(a, b)
        again = rs.rglru_scan(a, b)
        ref = rs.rglru_scan_plain(a, b)
        torch.cuda.synchronize()
        check(out.shape == a.shape and out.dtype == torch.float32,
              f"rglru_scan {case}: dtype/shape")
        check(bool(torch.isfinite(out).all()), f"rglru_scan {case}: finite")
        check(torch.equal(out, again), f"rglru_scan {case}: two launches "
              "differ")
        err = _max_err(out, ref)
        scale = float(ref.abs().max())
        check(err <= SCAN_RTOL * scale, f"rglru_scan {case}: max|err| "
              f"{err:.3e} > {SCAN_RTOL} x {scale:.3e}")
        worst = max(worst, err)
        print(f"  {'rglru_scan':17s} {'-'.join(map(str, case)):32s} "
              f"max|err| {err:.3e} (scale {scale:.3e}; "
              f"{rs.scan_chunks(*case)} chunks)")
    return worst


def bound(nbytes: float, flops: float) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def expand_heads(t, heads: int):
    """(B, S, K, hd) -> (B, heads, S, hd), each KV head repeated for its
    query heads: a view for K = 1 (stride 0), a copy otherwise."""
    B, S, K, hd = t.shape
    return t.transpose(1, 2)[:, :, None].expand(
        B, K, heads // K, S, hd).reshape(B, heads, S, hd)


def attention_yardsticks(q, k, v, causal: bool, window: int) -> dict:
    """name -> one ``scaled_dot_product_attention`` call computing
    ``flash_attention``'s function, in the (B, Sq, H, hd) layout: with the
    boolean mask and the KV heads expanded (a copy made before the timed
    call); without a window, also with ``is_causal=True`` (no mask tensor,
    so the dead tiles can be skipped) on the expanded heads and, where this
    PyTorch takes it on the card, on the KV heads as they are with
    ``enable_gqa=True``."""
    S, H = q.shape[1], q.shape[2]
    mask = fa.attention_mask(S, k.shape[1], causal, window, "cuda")
    qt, kt, vt = (expand_heads(t, H) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    calls = {"sdpa_mask": lambda: sdpa(qt, kt, vt,
                                       attn_mask=mask).transpose(1, 2)}
    if causal and window <= 0 and S == k.shape[1]:
        calls["sdpa_is_causal"] = lambda: sdpa(
            qt, kt, vt, is_causal=True).transpose(1, 2)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        try:
            sdpa(qh, kh, vh, is_causal=True, enable_gqa=True)
            torch.cuda.synchronize()
            calls["sdpa_is_causal_gqa"] = lambda: sdpa(
                qh, kh, vh, is_causal=True, enable_gqa=True).transpose(1, 2)
        except (TypeError, RuntimeError) as e:
            print(f"  {'flash_attention':17s} sdpa enable_gqa=True not "
                  f"taken: {type(e).__name__}: {str(e)[:120]}")
    return calls


def time_attention(case) -> dict:
    """``flash_attention`` at a serving shape, its plain version, the
    library yardsticks (``attention_yardsticks``, each checked against the
    plain version; ``library_ms`` is the fastest), and its bound from the
    unmasked (query, key) pairs of this shape."""
    flush = torch.empty(256 * 2**20 // 4, device="cuda")
    B, S, _, H, K, hd, causal, window = case
    q, k, v = attn_inputs(case)
    calls = attention_yardsticks(q, k, v, causal, window)
    ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    for name, call in calls.items():
        lib_err = _max_err(call(), ref)
        print(f"  {'flash_attention':17s} {name} vs plain max|err| "
              f"{lib_err:.3e}")
        check(lib_err <= 1e-3, f"{name} computes the same function")
    del ref
    iters = 10 if S > 256 else 100     # the CLI's prompt: microseconds
    lib = {name: time_ms(call, flush, iters, 2)
           for name, call in calls.items()}
    fastest = min(lib, key=lib.get)
    pairs = int(fa.attention_mask(S, S, causal, window, "cuda").sum()) * B * H
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    r = dict(ms=time_ms(lambda: fa.flash_attention(
                 q, k, v, causal=causal, window=window), flush, iters, 2),
             plain_ms=time_ms(lambda: fa.flash_attention_plain(
                 q, k, v, causal=causal, window=window), flush, iters // 2,
                 1),
             library_ms=lib[fastest], **bound(nbytes, 4 * hd * pairs))
    print(f"  {'flash_attention':17s} {'-'.join(map(str, case))}: "
          f"kernel {r['ms']:.3f} ms   plain {r['plain_ms']:.3f} ms   "
          + "   ".join(f"{n} {t:.3f} ms" for n, t in lib.items())
          + f"   bound {r['bound_ms']:.3f} ms ({r['bound_by']}: {pairs} "
          f"unmasked pairs, {nbytes} B); kernel/bound "
          f"{r['ms'] / r['bound_ms']:.2f}, kernel/{fastest} "
          f"{r['ms'] / r['library_ms']:.2f}")
    return r


def time_warps_rule(case) -> None:
    """``flash_attention`` with every warps-per-block count the kernel
    takes (``min_warps`` to ``MAX_WARPS``; a block's rows are
    ``rows_per_warp`` x warps) on the same inputs, the rule's choice
    (``attention_warps``) among them with its half and its double where
    those exist, so that the rule is checked on every run.  Twice 8 warps
    is past the kernel's 256-thread bound."""
    flush = torch.empty(256 * 2**20 // 4, device="cuda")
    B, S, _, H, K, hd, causal, window = case
    q, k, v = attn_inputs(case)
    chosen = fa.attention_warps(B, S, H, K, hd)
    times = []
    for w in (1, 2, 4, 8):
        if not fa.min_warps(hd) <= w <= fa.MAX_WARPS:
            continue
        with mock.patch.object(fa, "attention_warps", lambda *_, w=w: w):
            times.append((w, time_ms(lambda: fa.flash_attention(
                q, k, v, causal=causal, window=window), flush,
                10 if S > 256 else 100, 2)))
    print(f"  {'flash_attention':17s} {'-'.join(map(str, case))} warps: "
          + ", ".join(f"{w} ({fa.rows_per_warp(hd) * w} rows) -> "
                      f"{t:.3f} ms" for w, t in times)
          + f" (the rule picks {chosen})")


def time_scan() -> dict:
    """``rglru_scan`` at the serving shape with the chunk count its rule
    picks, one chunk and twice the rule's count, its plain version, and
    its bound.  No single PyTorch call computes the recurrence."""
    flush = torch.empty(256 * 2**20 // 4, device="cuda")
    a, b = scan_inputs(SCAN_SERVING)
    chosen = rs.scan_chunks(*SCAN_SERVING)
    chunked = []
    for c in (1, chosen, 2 * chosen):
        with mock.patch.object(rs, "scan_chunks", lambda *_, c=c: c):
            chunked.append((c, time_ms(lambda: rs.rglru_scan(a, b), flush)))
    r = dict(ms=chunked[1][1],
             plain_ms=time_ms(lambda: rs.rglru_scan_plain(a, b), flush, 20),
             library_ms=None, **bound(3 * 4 * a.numel(), 2 * a.numel()))
    print(f"  {'rglru_scan':17s} {'-'.join(map(str, SCAN_SERVING))}: "
          f"kernel {r['ms'] * 1e3:.2f} us   plain {r['plain_ms'] * 1e3:.2f} "
          f"us   bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}); "
          "chunks: " + ", ".join(f"{c} -> {t * 1e3:.2f} us"
                                 for c, t in chunked)
          + f" (the rule picks {chosen})")
    return r


# B, W, H, K, hd, pos, window, slot layout: tests/test_kernels.py's
# DECODE_CASES, its ring-wrapped case, an empty cache, a view [l] of a
# stacked (L, B, W, 2, K, hd) cache, then the decode shapes of phases 7
# (the ring full) and 8 (4,097 of 8,192 slots written) and of the CLI's
# default model, then the most query heads a KV head, a head dim that is
# not a multiple of 8 and more (batch, KV head) pairs than SMs.
DECODE_SERVING = (SERVE_BATCH, 2048, 16, 1, 256, SERVE_PROMPT, 2048, "ring")
DECODE_GLM = (SERVE_BATCH, 2 * SERVE_PROMPT, 32, 2, 128, SERVE_PROMPT, 0,
              "prefix")
DECODE_CLI = (CLI_BATCH, 2 * CLI_PROMPT, 32, 32, 64, CLI_PROMPT, 0, "prefix")
DECODE_CASES = [
    (2, 256, 8, 4, 64, 100, 0, "prefix"),
    (1, 300, 4, 2, 32, 299, 0, "prefix"),
    (2, 512, 8, 8, 128, 400, 128, "prefix"),
    (1, 64, 4, 1, 64, 10, 0, "prefix"),
    (2, 32, 4, 2, 16, 40, 0, "ring"),
    (2, 64, 8, 2, 32, 0, 0, "empty"),
    (2, 96, 8, 2, 32, 71, 64, "stacked"),
    DECODE_SERVING,
    DECODE_GLM,
    DECODE_CLI,
    (2, 512, 64, 2, 128, 300, 0, "prefix"),        # 32 heads a KV head
    (2, 200, 12, 3, 100, 150, 0, "prefix"),        # a padded head dim
    (300, 64, 4, 2, 32, 40, 0, "prefix"),          # 600 (batch, KV head) pairs
]


def decode_inputs(case, dtype=torch.float32):
    """q, k_cache, v_cache, slot_pos, pos on the card, from a seed."""
    B, W, H, K, hd, pos, window, layout = case
    if layout == "prefix":
        sp = np.full(W, -10**9, np.int32)
        sp[:min(pos + 1, W)] = np.arange(min(pos + 1, W))
    elif layout == "empty":
        sp = np.full(W, -10**9, np.int32)
    else:
        sp = np.asarray([pos - ((pos - w) % W) for w in range(W)])
        sp = np.where(sp >= 0, sp, -10**9).astype(np.int32)
    gen = torch.Generator(device="cuda").manual_seed(W + H + hd)
    q = torch.randn((B, 1, H, hd), generator=gen, device="cuda").to(dtype)
    sp = torch.from_numpy(sp).cuda()
    if layout == "stacked":
        kv = torch.randn((3, B, W, 2, K, hd), generator=gen,
                         device="cuda").to(dtype)
        poss = torch.tensor([pos - 1, pos, pos + 1], dtype=torch.int32,
                            device="cuda")
        return q, kv[1, :, :, 0], kv[1, :, :, 1], torch.stack(
            [sp - 1, sp, sp + 1])[1], poss[1]
    k, v = (torch.randn((B, W, K, hd), generator=gen, device="cuda").to(
        dtype) for _ in range(2))
    return q, k, v, sp, torch.tensor(pos, dtype=torch.int32, device="cuda")


def check_decode_against_plain() -> float:
    """``decode_attention`` on each case against its plain version (fp32
    within KERNEL_RTOL of the output's scale; one bf16 case within 2 bf16
    ulps), bit for bit between two launches, and the empty cache equal to
    the mean of V; returns the largest fp32 absolute error."""
    worst = 0.0
    for case, bf16 in [(c, False) for c in DECODE_CASES] + [
            (DECODE_CASES[0], True)]:
        window = case[6]
        args = decode_inputs(case, torch.bfloat16 if bf16 else torch.float32)
        out = da.decode_attention(*args, window=window)
        again = da.decode_attention(*args, window=window)
        ref = da.decode_attention_plain(*args, window=window)
        torch.cuda.synchronize()
        name = "-".join(map(str, case)) + ("-bf16" if bf16 else "")
        check(out.shape == args[0].shape and out.dtype == args[0].dtype,
              f"decode_attention {name}: dtype/shape")
        check(bool(torch.isfinite(out).all()), f"decode_attention {name}: "
              "finite")
        check(torch.equal(out, again), f"decode_attention {name}: two "
              "launches differ")
        err = _max_err(out.float(), ref.float())
        scale = float(ref.float().abs().max())
        tol = (2 * 2 ** -8 if bf16 else KERNEL_RTOL) * scale
        check(err <= tol, f"decode_attention {name}: max|err| {err:.3e} > "
              f"{tol:.3e}")
        if case[-1] == "empty":
            B, W, H, K, hd = case[:5]
            mean = args[2].mean(1).repeat_interleave(H // K, 1)[:, None]
            check(_max_err(out, mean) <= KERNEL_RTOL * scale,
                  "decode_attention: an empty cache gives the mean of V")
        if not bf16:
            worst = max(worst, err)
        splits, per = da.decode_splits(case[0] * case[3], case[1])
        print(f"  {'decode_attention':17s} {name:32s} max|err| {err:.3e} "
              f"(scale {scale:.3e}; {splits} splits of at most {per} "
              f"tiles)")
    return worst


def decode_yardsticks(q, k, v, mask) -> dict:
    """name -> one ``scaled_dot_product_attention`` call computing
    ``decode_attention``'s function with the valid-slot boolean mask: on
    the KV heads expanded to the query heads (a copy made before the timed
    call) and, where this PyTorch takes it on the card, on the KV heads as
    they are with ``enable_gqa=True``."""
    H = q.shape[2]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    m = mask[None, None, None]
    qt, kt, vt = (expand_heads(t, H) for t in (q, k, v))
    calls = {"sdpa_expanded": lambda: sdpa(qt, kt, vt,
                                           attn_mask=m).transpose(1, 2)}
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    try:
        sdpa(qh, kh, vh, attn_mask=m, enable_gqa=True)
        torch.cuda.synchronize()
        calls["sdpa_enable_gqa"] = lambda: sdpa(
            qh, kh, vh, attn_mask=m, enable_gqa=True).transpose(1, 2)
    except (TypeError, RuntimeError) as e:
        print(f"  {'decode_attention':17s} sdpa enable_gqa=True not taken: "
              f"{type(e).__name__}: {str(e)[:120]}")
    return calls


def time_decode(case) -> dict:
    """``decode_attention`` at a serving decode shape, its plain version,
    the library yardsticks (``decode_yardsticks``, each checked against the
    plain version; ``library_ms`` is the fastest) and its bound from the
    slots that count in this input: their K and V rows, q and the output
    (fp32), slot_pos and pos."""
    flush = torch.empty(256 * 2**20 // 4, device="cuda")
    B, W, H, K, hd, _, window, _ = case
    q, k, v, sp, pos = decode_inputs(case)
    mask = da.valid_slots(sp, pos, window)
    calls = decode_yardsticks(q, k, v, mask)
    ref = da.decode_attention_plain(q, k, v, sp, pos, window=window)
    for name, call in calls.items():
        lib_err = _max_err(call(), ref)
        print(f"  {'decode_attention':17s} {name} vs plain max|err| "
              f"{lib_err:.3e}")
        check(lib_err <= 1e-4, f"{name} computes the same function")
    lib = {name: time_ms(call, flush) for name, call in calls.items()}
    fastest = min(lib, key=lib.get)
    n_valid = int(mask.sum())
    nbytes = 4 * (2 * B * K * hd * n_valid + 2 * q.numel() + W + 1)
    r = dict(ms=time_ms(lambda: da.decode_attention(
                 q, k, v, sp, pos, window=window), flush),
             plain_ms=time_ms(lambda: da.decode_attention_plain(
                 q, k, v, sp, pos, window=window), flush),
             library_ms=lib[fastest],
             **bound(nbytes, 4 * B * H * hd * n_valid))
    splits, per = da.decode_splits(B * K, W)
    print(f"  {'decode_attention':17s} {'-'.join(map(str, case))}: "
          f"kernel {r['ms'] * 1e3:.2f} us   plain {r['plain_ms'] * 1e3:.2f} "
          "us   " + "   ".join(f"{n} {t * 1e3:.2f} us" for n, t in lib.items())
          + f"   bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}: "
          f"{n_valid} of {W} slots count, {nbytes} B; {splits} splits of at "
          f"most {per} tiles); "
          f"kernel/bound {r['ms'] / r['bound_ms']:.2f}, kernel/{fastest} "
          f"{r['ms'] / r['library_ms']:.2f}")
    return r


def time_split_rule(case) -> None:
    """``decode_attention`` with the split count its rule picks
    (``decode_attention.decode_splits``: a block per SM) against half and
    twice as many splits, on the same inputs, so that the rule is checked
    on every run.  Twice is left out where it would give a split no tile;
    where it asks for more blocks than the card holds at once, the
    cooperative launch is refused, and that is printed."""
    flush = torch.empty(256 * 2**20 // 4, device="cuda")
    B, W, H, K, hd, _, window, _ = case
    q, k, v, sp, pos = decode_inputs(case)
    tiles = -(-W // da.TILE)
    chosen = da.decode_splits(B * K, W)[0]
    times = []
    for splits in (max(1, chosen // 2), chosen, 2 * chosen):
        if splits > tiles:
            continue
        split = (splits, -(-tiles // splits))
        with mock.patch.object(da, "decode_splits", lambda *_: split), \
                mock.patch.dict(da._plans, clear=True):
            try:
                times.append((split, time_ms(lambda: da.decode_attention(
                    q, k, v, sp, pos, window=window), flush)))
            except RuntimeError as e:
                print(f"  {'decode_attention':17s} {splits} splits: {e}")
    print(f"  {'decode_attention':17s} {'-'.join(map(str, case))} splits: "
          + ", ".join(f"{n} (at most {p} tiles) -> {t * 1e3:.2f} us"
                      for (n, p), t in times)
          + f" (the rule picks {chosen})")


# ---------------------------------------------------------------------------
# Phases 3-4
# ---------------------------------------------------------------------------


def main_path_inputs():
    prob = HFLProblem(**MAIN)
    t0 = time.perf_counter()
    sch = plan(prob)
    plan_s = time.perf_counter() - t0
    train, test = synthetic_mnist(seed=0)
    parts = size_partition(np.random.default_rng(0), len(train["labels"]),
                           prob.samples.astype(int))
    ue_data = [{k: train[k][ix] for k in train} for ix in parts]
    return sch, plan_s, ue_data, test


def make_sim(sch, ue_data, device, noise=0.0, noise_seed=1, **kw):
    init = lenet_init(torch.Generator().manual_seed(0), LeNetConfig(),
                      device="cpu")
    if noise:
        gen = torch.Generator().manual_seed(noise_seed)
        init = {k: {kk: v * (1 + noise * torch.randn(v.shape, generator=gen))
                    for kk, v in layer.items()} for k, layer in init.items()}
    init = {k: {kk: v.to(device) for kk, v in layer.items()}
            for k, layer in init.items()}
    return HFLSimulator(sch, lenet_loss, init, ue_data, lr=LR,
                        samples_per_ue=SAMPLES_PER_UE, device=device, **kw)


def phase_main_path(sch, plan_s, ue_data, test):
    rounds = ROUNDS
    print(f"plan: a*={sch.a} b*={sch.b} R={sch.rounds} "
          f"T={sch.cloud_round_time!r} s ({plan_s:.3f} s to plan); "
          f"{sch.num_edges} edges x {sch.num_ues} UEs")
    sim = make_sim(sch, ue_data, "cuda")
    print(f"flat buffer {tuple(sim._flat.shape)} fp32 on "
          f"{sim._flat.device}; LeNetConfig() full width; "
          f"{SAMPLES_PER_UE} samples per UE; {rounds} cloud rounds "
          f"(a*b* = {sch.a * sch.b} GD steps each)")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = sim.run(test, rounds=rounds, verbose=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = counts()
    print(f"main path: {run_s:.3f} s for {rounds} cloud rounds "
          f"({run_s / rounds:.3f} s per round, first-call warm-up included)")
    print(f"launches during the main path: {launches}")
    check(launches == expect(segment_aggregate=sch.b * rounds,
                             cloud_aggregate=rounds),
          f"launch counts {launches} != b*rounds={sch.b * rounds}, "
          f"rounds={rounds}")
    check(bool(np.isfinite(res.test_loss).all()
               and np.isfinite(res.train_loss).all()), "finite losses")
    check(all(bool(torch.isfinite(t).all())
              for t in tree_leaves(res.final_params)), "finite params")
    t0 = time.perf_counter()
    sim.run(test, rounds=1)
    torch.cuda.synchronize()
    print(f"one more cloud round, warm: {time.perf_counter() - t0:.3f} s")
    profile_round(sim, test)
    return launches


def run_summary(res) -> dict:
    """A ``SimResult``'s curves and final params, on the host."""
    return dict(test_acc=res.test_acc, test_loss=res.test_loss,
                train_loss=res.train_loss,
                final=[t.cpu() for t in tree_leaves(res.final_params)])


def device_profile(fn):
    """Run ``fn`` once under ``torch.profiler``; returns the wall time in
    us and the device kernels that took time (``key_averages`` entries)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    return wall_us, [e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA
                     and e.self_device_time_total > 0]


def print_top(kernels, top: int) -> None:
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")


def profile_round(sim, test, top: int = 8) -> None:
    """Where a warm cloud round's device time goes (``torch.profiler``):
    device-busy share of the wall time, the aggregation kernels' share,
    and the kernels that take the most device time."""
    wall_us, kernels = device_profile(lambda: sim.run(test, rounds=1))
    if not kernels:
        print("profiled round: the profiler recorded no device time")
        return
    busy_us = sum(e.self_device_time_total for e in kernels)
    agg_us = sum(e.self_device_time_total for e in kernels
                 if "aggregate_kernel" in e.key)
    print(f"profiled round: {wall_us / 1e6:.3f} s wall (profiler on), "
          f"device busy {busy_us / 1e6:.3f} s = {busy_us / wall_us:.1%}; "
          f"aggregation kernels {agg_us / 1e3:.3f} ms = "
          f"{agg_us / busy_us:.2%} of device time; "
          f"{sum(e.count for e in kernels)} kernel launches")
    print_top(kernels, top)


def phase_card_vs_cpu(sch, ue_data, test):
    def final(device, noise=0.0):
        t0 = time.perf_counter()
        res = make_sim(sch, ue_data, device, noise=noise).run(test, rounds=1)
        if device == "cuda":
            torch.cuda.synchronize()
        print(f"  one cloud round on {device}"
              f"{' (init moved by %g)' % noise if noise else ''}: "
              f"{time.perf_counter() - t0:.2f} s, test loss "
              f"{float(res.test_loss[-1])!r}")
        return [t.cpu() for t in tree_leaves(res.final_params)]

    torch.set_num_threads(os.cpu_count() or 1)
    gpu, cpu = final("cuda"), final("cpu")
    cpu_moved = final("cpu", noise=SENSITIVITY_NOISE)
    diff = max(_max_err(a, b) for a, b in zip(gpu, cpu))
    spread = max(_max_err(a, b) for a, b in zip(cpu, cpu_moved))
    scale = max(float(t.abs().max()) for t in cpu)
    print(f"  card vs CPU: max|diff| {diff:.3e}; CPU spread under a "
          f"{SENSITIVITY_NOISE:g} init move {spread:.3e}; largest param "
          f"{scale:.3e}")
    check(spread > 0, "the perturbed CPU run moved")
    check(diff <= SENSITIVITY_FACTOR * spread,
          f"card vs CPU {diff:.3e} > {SENSITIVITY_FACTOR} x CPU spread "
          f"{spread:.3e}")
    return gpu, spread


# ---------------------------------------------------------------------------
# Phases 5-6
# ---------------------------------------------------------------------------


def departure_waves(timeline) -> int:
    """Departure waves the async replay runs: the runs of departures that
    a cloud update closes."""
    waves, pending = 0, False
    for kind, _ in timeline.trace:
        if kind == "depart":
            pending = True
        elif kind == "update" and pending:
            waves, pending = waves + 1, False
    return waves


def phase_async(sch, ue_data, test, card_sync, spread) -> None:
    sim = make_sim(sch, ue_data, "cuda", mode="async",
                   max_staleness=ASYNC_STALENESS)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = sim.run(test, rounds=ROUNDS, verbose=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = counts()
    tl = res.timeline
    waves = departure_waves(tl)
    updates = len(tl.updates)
    print(f"async path: max_staleness={ASYNC_STALENESS}, {ROUNDS} rounds' "
          f"quota = {updates} cloud updates, {waves} departure waves")
    print(f"launches during the async path: {launches}")
    check(launches == expect(segment_aggregate=sch.b * waves),
          f"launch counts {launches} != b*waves={sch.b * waves}, 0, 0")
    check(bool(np.isfinite(res.test_loss).all()
               and np.isfinite(res.train_loss).all()), "async: finite losses")
    check(all(bool(torch.isfinite(t).all())
              for t in tree_leaves(res.final_params)), "async: finite params")
    bound = ROUNDS * sch.cloud_round_time
    print(f"async makespan {tl.makespan!r} s simulated against the eq. 34 "
          f"bound {bound!r} s ({bound / tl.makespan:.4f}x); wall "
          f"{run_s:.3f} s, {run_s / updates:.3f} s per cloud update "
          f"(first-call warm-up included)")
    barrier = make_sim(sch, ue_data, "cuda", mode="async", max_staleness=0)
    res0 = barrier.run(test, rounds=1)
    torch.cuda.synchronize()
    diff = max(_max_err(a.cpu(), b) for a, b in
               zip(tree_leaves(res0.final_params), card_sync))
    print(f"  async max_staleness=0 vs the card's sync round: max|diff| "
          f"{diff:.3e}; CPU spread (phase 4) {spread:.3e}")
    check(diff <= SENSITIVITY_FACTOR * spread,
          f"async barrier vs sync {diff:.3e} > {SENSITIVITY_FACTOR} x CPU "
          f"spread {spread:.3e}")


def stream_chunk(i: int, rows: int) -> torch.Tensor:
    """Chunk ``i`` of the streamed rows, made on the card from a generator
    keyed by (STREAM_SEED, i)."""
    seed = int(np.random.SeedSequence([STREAM_SEED, i]).generate_state(1)[0])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(rows, STREAM_COLS, generator=gen, device="cuda")


def phase_streaming() -> int:
    n, f, m, chunk = STREAM_ROWS, STREAM_COLS, STREAM_GROUPS, STREAM_CHUNK
    rng = np.random.default_rng(0)          # as benchmarks/bench_scale.py
    gid = torch.as_tensor(rng.integers(0, m, n).astype(np.int32),
                          device="cuda")
    w = torch.as_tensor(rng.uniform(0.5, 2.0, n).astype(np.float32),
                        device="cuda")
    acc = StreamingEdgeAccumulator(m, f, device="cuda")
    starts = range(0, n, chunk)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for i, start in enumerate(starts):
        stop = min(start + chunk, n)
        acc.add(stream_chunk(i, stop - start), w[start:stop],
                gid[start:stop])
    means = acc.edge_means()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    print(f"streaming: {n} rows x {f} fp32 in {len(starts)} chunks of "
          f"{chunk}, M={m}: {wall:.3f} s, {n / wall:.4g} rows/s (chunk "
          f"generation included); resident {acc.resident_bytes()} B, "
          f"chunk {chunk * f * 4} B, full buffer avoided {n * f * 4} B")
    print(f"launches during the streaming path: {launches}")
    check(launches == expect(segment_sum=len(starts)),
          f"launch counts {launches} != 0, 0, {len(starts)}")
    check(acc.resident_bytes() == m * f * 4 + m * 4,
          f"resident bytes {acc.resident_bytes()} != {m * f * 4 + m * 4}")
    num = torch.zeros(m, f, dtype=torch.float64, device="cuda")
    mass = torch.zeros(m, dtype=torch.float64, device="cuda")
    for i, start in enumerate(starts):
        stop = min(start + chunk, n)
        g, ww = gid[start:stop].long(), w[start:stop].double()
        num.index_add_(0, g, ww[:, None] * stream_chunk(i, stop - start)
                       .double())
        mass.index_add_(0, g, ww)
    ref = num / mass[:, None]
    check(bool(torch.isfinite(means).all()), "streaming: finite means")
    err = float((means.double() - ref).abs().max())
    scale = float(ref.abs().max())
    print(f"  edge means vs float64 accumulation: max|err| {err:.3e} "
          f"(largest |mean| {scale:.3e})")
    check(err <= STREAM_RTOL * scale,
          f"streaming means: max|err| {err:.3e} > {STREAM_RTOL} x "
          f"{scale:.3e}")
    profile_chunks(w[:chunk], gid[:chunk])
    return launches["segment_sum"]


def profile_chunks(w, gid, chunks: int = 10) -> None:
    """``chunks`` chunks of phase 6 folded as the path folds them (each
    made on the card just before, so it may sit in L2), under
    ``torch.profiler``: ``segment_sum``'s device time a launch on the path
    and every kernel a fold launches."""
    acc = StreamingEdgeAccumulator(STREAM_GROUPS, STREAM_COLS, device="cuda")

    def fold():
        for i in range(chunks):
            acc.add(stream_chunk(i, STREAM_CHUNK), w, gid)

    fold()
    wall_us, kernels = device_profile(fold)
    k4 = [e for e in kernels if "segment_sum" in e.key
          or "sum_slices" in e.key]
    print(f"  profiled {chunks} chunks: {wall_us / chunks:.1f} us wall a "
          "chunk (profiler on); segment_sum on the path: "
          + "; ".join(f"{e.key[:60]} {e.count}x "
                      f"{e.self_device_time_total / e.count:.2f} us"
                      for e in k4))
    print_top(kernels, 8)


# ---------------------------------------------------------------------------
# Phase 7
# ---------------------------------------------------------------------------


def perturbed(params, seed: int = 1) -> dict:
    """``params`` with the embedding moved by SENSITIVITY_NOISE relative
    (a fresh tensor; the other leaves are shared)."""
    emb = params["embedding"]
    gen = torch.Generator(device=emb.device).manual_seed(seed)
    noise = torch.randn(emb.shape, generator=gen, device=emb.device)
    moved = noise.mul_(SENSITIVITY_NOISE).add_(1.0).mul_(emb)
    return dict(params, embedding=moved)


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    return tree.cpu()


def teacher_forced(model, params, state, tokens) -> list:
    """Decode logits of ``tokens`` (B, n) fed one at a time from ``state``."""
    out = []
    for i in range(tokens.shape[1]):
        logits, state = model.decode_step(params, state, tokens[:, i:i + 1])
        out.append(logits)
    return out


def max_diff(a, b) -> float:
    if isinstance(a, list):
        return max(max_diff(x, y) for x, y in zip(a, b))
    return _max_err(a.float(), b.float())


def print_serving_profile(kernels, wall_us, label) -> None:
    if not kernels:
        print(f"profiled {label}: the profiler recorded no device time")
        return
    busy_us = sum(e.self_device_time_total for e in kernels)
    groups = {"flash_attention": ("flash_attention_kernel",),
              "rglru_scan": ("scan_kernel", "chunk_summary_kernel"),
              "decode_attention": ("decode_attention_kernel",),
              "matrix products": ("gemm",)}
    shares = {name: sum(e.self_device_time_total for e in kernels
                        if any(k in e.key.lower() for k in keys))
              for name, keys in groups.items()}
    counts = {name: sum(e.count for e in kernels
                        if any(k in e.key.lower() for k in keys))
              for name, keys in groups.items()}
    print(f"profiled {label}: {wall_us / 1e3:.3f} ms wall (profiler on), "
          f"device busy {busy_us / 1e3:.3f} ms = {busy_us / wall_us:.1%}; "
          + "; ".join(f"{n} {t / 1e3:.3f} ms = {t / busy_us:.1%} "
                      f"({counts[n]} kernels)" for n, t in shares.items())
          + f"; {sum(e.count for e in kernels)} kernel launches")
    print_top(kernels, 8)


def phase_serve_cli(argv, batch: int, prefill: dict,
                    attn_layers: int) -> None:
    """``repro_torch.launch.serve``'s entry point at full width: ``prefill``
    launches in prefill and ``attn_layers`` ``decode_attention`` launches
    per decode step, nothing else; (batch, SERVE_GEN) tokens."""
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    res = serve.main(argv)
    launches = counts()
    gen = SERVE_GEN - 1
    print(f"serve CLI {argv}: launches {launches}; peak memory "
          f"{torch.cuda.max_memory_allocated()} B")
    check(launches == expect(decode_attention=attn_layers * gen, **prefill),
          f"serve CLI launch counts {launches} != {prefill} (prefill), "
          f"{attn_layers} x {gen} decode_attention, none else")
    check(tuple(res["tokens"].shape) == (batch, SERVE_GEN),
          "serve CLI: tokens")


def phase_serving(arch: str, n_params: int, prefill: dict,
                  attn_layers: int) -> dict:
    """Full-width ``arch`` from seed 0, B=SERVE_BATCH, SERVE_PROMPT prompt
    tokens, SERVE_GEN greedy tokens: timed, launch-counted (``prefill``
    launches in prefill, ``attn_layers`` ``decode_attention`` per decode
    step), profiled, and the kernel route against the plain route."""
    cfg = get_config(arch)
    model = Model(cfg)
    check(model.num_params() == n_params,
          f"{model.num_params()} parameters != {n_params}")
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.num_layers} layers "
          f"({', '.join(sorted(set(cfg.layer_kinds)))}), d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads over {cfg.num_kv_heads} KV "
          f"head(s) of {cfg.resolved_head_dim}, window "
          f"{cfg.local_window or cfg.sliding_window}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}; {model.num_params()} fp32 parameters from seed "
          f"0 on the card in {time.perf_counter() - t0:.2f} s")
    prompts = torch.as_tensor(TokenStream(cfg.vocab_size, seed=0).batch(
        SERVE_BATCH, SERVE_PROMPT)["tokens"], device="cuda")
    torch.cuda.reset_peak_memory_stats()

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits, state = model.prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = counts()
    print(f"prefill B={SERVE_BATCH} S={SERVE_PROMPT}: {prefill_s:.3f} s; "
          f"launches {launches}")
    check(launches == expect(**prefill),
          f"prefill launch counts {launches} != {prefill}, none else")
    tokens = [torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]]
    decode_logits = []
    st = state
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(SERVE_GEN - 1):
        lg, st = model.decode_step(params, st, tokens[-1])
        decode_logits.append(lg)
        tokens.append(torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None])
    torch.cuda.synchronize()
    decode_s = (time.perf_counter() - t0) / (SERVE_GEN - 1)
    decoded = counts()
    check(decoded == expect(decode_attention=attn_layers * (SERVE_GEN - 1)),
          f"decode launch counts {decoded} != {attn_layers} x "
          f"{SERVE_GEN - 1} decode_attention, none else")
    tokens = torch.cat(tokens, 1)
    peak = torch.cuda.max_memory_allocated()
    print(f"decode: {SERVE_GEN - 1} greedy steps, {decode_s * 1e3:.3f} "
          f"ms/token (B={SERVE_BATCH}); launches {decoded}; peak memory "
          f"{peak} B; tokens[0, :16] {tokens[0, :16].tolist()}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          "tokens in range")
    check(bool(torch.isfinite(logits).all()) and all(
        bool(torch.isfinite(t).all()) for t in decode_logits),
        "finite logits")

    wall, kernels = device_profile(
        lambda: model.prefill(params, {"tokens": prompts}))
    print_serving_profile(kernels, wall, "prefill")
    wall, kernels = device_profile(
        lambda: model.decode_step(params, st, tokens[:, -1:]))
    print_serving_profile(kernels, wall, "decode step")

    naive = Model(cfg, impl="naive")
    n_logits, n_state = naive.prefill(params, {"tokens": prompts})
    n_decode = teacher_forced(naive, params, n_state, tokens[:, :-1])
    del n_state
    moved = perturbed(params)
    m_logits, m_state = naive.prefill(moved, {"tokens": prompts})
    m_decode = teacher_forced(naive, moved, m_state, tokens[:, :-1])
    del moved, m_state
    hold_to_spread("kernel vs plain route", "prefill logits", logits,
                   n_logits, n_logits, m_logits)
    hold_to_spread("kernel vs plain route", "teacher-forced decode logits",
                   decode_logits, n_decode, n_decode, m_decode)
    return dict(prefill_s=prefill_s, decode_s=decode_s, peak=peak,
                launches={k: launches[k] + decoded[k] for k in launches})


def hold_to_spread(label: str, what: str, tested, reference, plain,
                   plain_moved) -> None:
    """``tested`` within SENSITIVITY_FACTOR times the plain route's own
    spread (``plain`` against ``plain_moved``, the embedding moved by
    SENSITIVITY_NOISE) of ``reference``."""
    diff, spread = max_diff(tested, reference), max_diff(plain, plain_moved)
    scale = max(float(t.abs().max()) for t in (
        reference if isinstance(reference, list) else [reference]))
    print(f"  {label}, {what}: max|diff| {diff:.3e}; plain spread under a "
          f"{SENSITIVITY_NOISE:g} embedding move {spread:.3e} (ratio "
          f"{diff / max(spread, 1e-30):.2f}); largest |logit| {scale:.3e}")
    check(spread > 0, f"{label}, {what}: the perturbed plain route moved")
    check(diff <= SENSITIVITY_FACTOR * spread,
          f"{label}, {what}: {diff:.3e} > {SENSITIVITY_FACTOR} x spread "
          f"{spread:.3e}")


def phase_serving_card_vs_cpu(arch: str, layers: int, prompt: int,
                              prefill: dict, attn_layers: int) -> None:
    """``layers`` layers of ``arch`` at full width, B=CPU_BATCH: the card's
    kernel route against the CPU (whose wrappers take the plain versions)
    on the prefill logits and CPU_STEPS teacher-forced decode steps, held
    to SENSITIVITY_FACTOR times the card's plain-route spread."""
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    card = Model(cfg)
    params = card.init(0)
    tokens = TokenStream(cfg.vocab_size, seed=0).batch(
        CPU_BATCH, prompt + CPU_STEPS)["tokens"]
    batch, follow = {"tokens": tokens[:, :prompt]}, tokens[:, prompt:]
    reset_counts()
    logits, state = card.prefill(params, batch)
    torch.cuda.synchronize()
    check(counts() == expect(**prefill),
          f"{layers}-layer prefill launch counts {counts()}")
    reset_counts()
    decode = teacher_forced(card, params, state, follow)
    torch.cuda.synchronize()
    check(counts() == expect(decode_attention=attn_layers * CPU_STEPS),
          f"{layers}-layer decode launch counts {counts()}")
    naive = Model(cfg, impl="naive")
    plain, st = naive.prefill(params, batch)
    plain_dec = teacher_forced(naive, params, st, follow)
    moved_params = perturbed(params)
    moved, st = naive.prefill(moved_params, batch)
    moved_dec = teacher_forced(naive, moved_params, st, follow)
    cpu_params = to_cpu(params)
    del params, moved_params, state, st
    torch.set_num_threads(os.cpu_count() or 1)
    cpu = Model(cfg, device="cpu")
    t0 = time.perf_counter()
    cpu_logits, cpu_state = cpu.prefill(cpu_params, batch)
    cpu_dec = teacher_forced(cpu, cpu_params, cpu_state, follow)
    print(f"  card vs CPU, {layers} layers, B={CPU_BATCH} S={prompt} + "
          f"{CPU_STEPS} decode steps: CPU {time.perf_counter() - t0:.1f} s")
    hold_to_spread("card vs CPU", "prefill logits", logits.cpu(),
                   cpu_logits, plain, moved)
    hold_to_spread("card vs CPU", "teacher-forced decode logits",
                   [t.cpu() for t in decode], cpu_dec, plain_dec, moved_dec)


# ---------------------------------------------------------------------------
# Phase 9
# ---------------------------------------------------------------------------


def sharded_rank(sch, ue_data, test) -> dict:
    """One rank of phase 9, run by ``run_ranks`` (``spawn`` imports this
    script in each rank; ``main`` does not run there)."""
    import datetime

    import torch.distributed as dist
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True       # as phase_sharded
    mesh = make_agg_mesh(1, SHARD_RANKS, timeout=datetime.timedelta(
        seconds=RANK_TIMEOUT_S))
    sim = make_sim(sch, ue_data, mesh.device, mesh=mesh)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = sim.run(test, rounds=ROUNDS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = counts()
    t0 = time.perf_counter()
    sim.run(test, rounds=1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    x, w = fleet_shard(mesh.rank)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = flat_cloud_aggregate(x, w, mesh=mesh)
    torch.cuda.synchronize()
    fleet_s = time.perf_counter() - t0
    fleet_launches = counts()
    num = torch.zeros(LENET_PARAMS, dtype=torch.float64, device=x.device)
    for start in range(0, FLEET_ROWS, 2048):
        num += w[start:start + 2048].double() @ x[start:start + 2048].double()
    v = torch.cat([num, w.double().sum()[None]])
    dist.all_reduce(v, group=mesh.data_group)
    ref = v[:-1] / v[-1]
    return dict(rank=mesh.rank, device=str(mesh.device),
                slab=tuple(sim._flat.shape), run_s=run_s, warm_s=warm_s,
                launches=launches, summary=run_summary(res),
                fleet_s=fleet_s, fleet_launches=fleet_launches,
                fleet_err=float((out.double() - ref).abs().max()),
                fleet_scale=float(ref.abs().max()),
                fleet_finite=bool(torch.isfinite(out).all()))


def phase_sharded(sch, ue_data, test) -> dict:
    """Phase 9; returns each kernel's launches summed over the ranks and
    over the sharded run and the fleet-scale event."""
    # cuDNN's default algorithms make a LeNet run on the card differ from
    # itself from run to run: two runs of phase 3's problem came up to
    # 7.7e-6 apart in train loss and 3.7e-4 in the params, as far as the
    # sharded run lies from either.  So the reference (phase 3's run
    # again), its moved runs and the ranks take cuDNN's deterministic
    # algorithms, and each gives the same result on every run.
    torch.backends.cudnn.deterministic = True
    try:
        return _phase_sharded(sch, ue_data, test)
    finally:
        torch.backends.cudnn.deterministic = False


def _phase_sharded(sch, ue_data, test) -> dict:
    unsharded = run_summary(make_sim(sch, ue_data, "cuda").run(
        test, rounds=ROUNDS))
    # The spread of that run itself, over the same ROUNDS rounds, when its
    # init moves by SENSITIVITY_NOISE relative (the largest over
    # SPREAD_SEEDS draws of the move: one draw's train-loss spread came out
    # 10x under its test-loss one): the sharded run differs from it only
    # in the order of the cloud sums.
    spread = dict.fromkeys(("final", "test_loss", "train_loss"), 0.0)
    for seed in SPREAD_SEEDS:
        moved = run_summary(make_sim(sch, ue_data, "cuda",
                                     noise=SENSITIVITY_NOISE,
                                     noise_seed=seed).run(test, rounds=ROUNDS))
        spread["final"] = max(spread["final"], max(
            _max_err(a, b) for a, b in zip(moved["final"],
                                           unsharded["final"])))
        for key in ("test_loss", "train_loss"):
            spread[key] = max(spread[key], float(
                np.abs(moved[key] - unsharded[key]).max()))
    torch.cuda.empty_cache()        # the ranks share the card with us
    t0 = time.perf_counter()
    ranks = run_ranks(sharded_rank, SHARD_RANKS, sch, ue_data, test,
                      device="cuda", timeout_s=RANK_TIMEOUT_S)
    print(f"{SHARD_RANKS} ranks (gloo, both on {ranks[0]['device']}, so "
          f"they share one card) on a {SHARD_RANKS} x 1 mesh: "
          f"{time.perf_counter() - t0:.1f} s from spawn to results")
    per_rank = expect(segment_aggregate=sch.b * ROUNDS,
                      weighted_mean=ROUNDS)
    for r in ranks:
        print(f"  rank {r['rank']}: slab {r['slab']} fp32; {ROUNDS} rounds "
              f"{r['run_s']:.3f} s (first-call warm-up included), one more "
              f"round, warm: {r['warm_s']:.3f} s; launches {r['launches']}")
        check(r["slab"] == (SHARD_ROWS, LENET_PARAMS),
              f"rank {r['rank']}: slab {r['slab']}")
        check(r["launches"] == per_rank, f"rank {r['rank']}: launch counts "
              f"{r['launches']} != {per_rank}")
    first = ranks[0]["summary"]
    for r in ranks[1:]:
        check(all(np.array_equal(first[k], r["summary"][k])
                  for k in ("test_acc", "test_loss", "train_loss"))
              and all(torch.equal(a, b) for a, b in
                      zip(first["final"], r["summary"]["final"])),
              "the ranks' results differ")
    for key in ("final", "test_loss", "train_loss"):
        if key == "final":
            diff = max(_max_err(a, b) for a, b in
                       zip(first["final"], unsharded["final"]))
        else:
            diff = float(np.abs(first[key] - unsharded[key]).max())
        ratio = diff / max(spread[key], 1e-30)
        print(f"  sharded vs the unsharded run, {key}: max|diff| "
              f"{diff:.3e}; spread of that run under a {SENSITIVITY_NOISE:g} "
              f"init move {spread[key]:.3e} (largest of "
              f"{len(SPREAD_SEEDS)} moves; ratio {ratio:.2f})")
        check(spread[key] > 0, f"the perturbed run's {key} moved")
        check(diff <= SENSITIVITY_FACTOR * spread[key],
              f"sharded {key} {diff:.3e} > {SENSITIVITY_FACTOR} x spread "
              f"{spread[key]:.3e}")
    n_test = len(test["labels"])
    acc = float(np.abs(first["test_acc"] - unsharded["test_acc"]).max())
    print(f"  test accuracy {first['test_acc'].tolist()} against "
          f"{unsharded['test_acc'].tolist()}")
    check(acc <= 1.0 / n_test + 1e-9, f"sharded accuracy {acc} apart, more "
          f"than one of {n_test} test samples")

    for r in ranks:
        print(f"  fleet-scale cloud event, rank {r['rank']}: {FLEET_ROWS} x "
              f"{LENET_PARAMS} fp32 ({FLEET_ROWS * LENET_PARAMS * 4} B) in "
              f"{r['fleet_s'] * 1e3:.3f} ms (host clock, synchronised; the "
              f"all-reduce of {LENET_PARAMS + 1} floats through gloo "
              f"included); max|err| against float64 {r['fleet_err']:.3e} "
              f"(largest |mean| {r['fleet_scale']:.3e}); launches "
              f"{r['fleet_launches']}")
        check(r["fleet_finite"], "fleet-scale event: finite")
        check(r["fleet_err"] <= STREAM_RTOL * r["fleet_scale"],
              f"fleet-scale event: max|err| {r['fleet_err']:.3e} > "
              f"{STREAM_RTOL} x {r['fleet_scale']:.3e}")
        check(r["fleet_launches"] == expect(weighted_mean=1),
              f"fleet-scale launch counts {r['fleet_launches']}")
    return {name: sum(r["launches"][name] + r["fleet_launches"][name]
                      for r in ranks) for name in KERNELS}


# ---------------------------------------------------------------------------


def time_aggregation() -> int:
    """``--time-aggregation``: K1, K2, K3 and K4 timed at the paths'
    shapes and phase 6, nothing else.  Only the wrappers' signatures are
    used, so the same script times an older tree's kernels (copy it into
    that tree) in the same call, for a comparison on one card."""
    print("== aggregation kernels only")
    t0 = time.perf_counter()
    paths = build.build(["segment_aggregate", "cloud_aggregate",
                         "weighted_mean", "segment_sum"])
    print(f"built {', '.join(paths)} in {time.perf_counter() - t0:.2f} s")
    for name, path in paths.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line:
                print(f"  {name}: {line.strip()}")
    cases = kernel_cases("cuda")
    time_kernels(*cases["main_n100_f44426"])
    time_kernels(*cases["slab_n60_f44426"], names=("segment_aggregate",))
    s_cases = sum_cases("cuda")
    time_segment_sum(*s_cases["stream_n8192_f1024"])
    time_segment_sum(*s_cases["lenet_n100_f44426"])
    time_mean(*cases["slab_n60_f44426"][:2])
    del cases, s_cases
    x, w = fleet_shard(0)
    time_mean(x, w)
    time_mean(x.to(torch.bfloat16), w)
    del x, w
    phase_streaming()
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    if argv == ["--time-aggregation"]:
        return time_aggregation()
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    print("== phase 1: device")
    phase_device()

    print("== phase 2: kernels vs plain versions on the card")
    cases = kernel_cases("cuda")
    errs = check_kernels_against_plain(cases)
    timing = time_kernels(*cases["main_n100_f44426"])
    time_kernels(*cases["slab_n60_f44426"], names=("segment_aggregate",))
    time_aggregate_warps_rule(*cases["main_n100_f44426"])
    time_aggregate_warps_rule(*cases["slab_n60_f44426"])
    time_aggregate_warps_rule(*cases["main_n100_f44426"],
                              name="cloud_aggregate")
    s_cases = sum_cases("cuda")
    errs["segment_sum"] = check_segment_sum_against_plain(s_cases)
    check_one_launch(aggregation_calls(cases, s_cases))
    timing["segment_sum"] = time_segment_sum(*s_cases["stream_n8192_f1024"])
    time_slice_rule(*s_cases["stream_n8192_f1024"])
    time_segment_sum(*s_cases["lenet_n100_f44426"])
    del cases, s_cases
    errs["flash_attention"] = check_attention_against_plain()
    timing["flash_attention"] = time_attention(ATTN_SERVING)
    time_attention(ATTN_GLM)
    time_attention(ATTN_CLI)
    for case in (ATTN_SERVING, ATTN_GLM, ATTN_CLI):
        time_warps_rule(case)
    errs["rglru_scan"] = check_scan_against_plain()
    timing["rglru_scan"] = time_scan()
    errs["decode_attention"] = check_decode_against_plain()
    time_decode(DECODE_SERVING)
    timing["decode_attention"] = time_decode(DECODE_GLM)
    time_decode(DECODE_CLI)
    for case in (DECODE_SERVING, DECODE_GLM):
        time_split_rule(case)
    m_cases = mean_cases()
    errs["weighted_mean"] = check_mean_against_plain(m_cases)
    check_one_launch({"weighted_mean": [
        lambda x=x, w=w: ha.weighted_mean(x, w)
        for x, w in m_cases.values()]})
    for case in ("slab_n60_f44426", "fleet_n16384_f44426", "bf16_fleet"):
        x, w = m_cases[case]
        r = time_mean(x, w, note=f"; {plan_line(x)}")
        timing.setdefault("weighted_mean", r)
    del x, w
    for case in ("slab_n60_f44426", "fleet_n16384_f44426", "bf16_fleet"):
        time_mean_slice_rule(*m_cases[case])
    del m_cases

    print("== phase 3: main path at full width")
    sch, plan_s, ue_data, test = main_path_inputs()
    launches = phase_main_path(sch, plan_s, ue_data, test)

    print("== phase 4: the card against the CPU, one cloud round")
    card_sync, spread = phase_card_vs_cpu(sch, ue_data, test)

    print("== phase 5: async Algorithm 1 at full width")
    phase_async(sch, ue_data, test, card_sync, spread)

    print("== phase 6: streaming edge aggregation, 1,048,576 rows")
    launches["segment_sum"] = phase_streaming()

    print("== phase 7: serving full-width RecurrentGemma-9B")
    rg_prefill = dict(flash_attention=12, rglru_scan=26)
    phase_serve_cli(["--arch", SERVE_ARCH, "--batch", str(SERVE_BATCH),
                     "--prompt-len", str(SERVE_PROMPT), "--gen",
                     str(SERVE_GEN), "--seed", "0"], SERVE_BATCH, rg_prefill,
                    12)
    served = phase_serving(SERVE_ARCH, SERVE_PARAMS, rg_prefill, 12)
    phase_serving_card_vs_cpu(SERVE_ARCH, 3, CPU_PROMPT,
                              dict(flash_attention=1, rglru_scan=2), 1)

    print("== phase 8: serving the scanned dense stack: full-width "
          "ChatGLM3-6B, then the serving CLI's default")
    glm = phase_serving(GLM_ARCH, GLM_PARAMS, dict(flash_attention=28), 28)
    phase_serving_card_vs_cpu(GLM_ARCH, 3, GLM_CPU_PROMPT,
                              dict(flash_attention=3), 3)
    check(Model(get_config(CLI_ARCH)).num_params() == CLI_PARAMS,
          f"{CLI_ARCH}: parameters != {CLI_PARAMS}")
    phase_serve_cli([], CLI_BATCH, dict(flash_attention=CLI_LAYERS),
                    CLI_LAYERS)
    for name in ("flash_attention", "rglru_scan", "decode_attention"):
        launches[name] = served["launches"][name] + glm["launches"][name]

    print("== phase 9: data-sharded sync Algorithm 1, 2 ranks on the card")
    sharded = phase_sharded(sch, ue_data, test)
    for name in ("segment_aggregate", "weighted_mean"):
        launches[name] += sharded[name]

    print(f"total {time.perf_counter() - t_start:.1f} s")
    print("kernels: " + ", ".join(KERNELS))
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", **meta, launches=launches[name],
             max_abs_err=errs[name], **timing[name])
        for name, meta in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
