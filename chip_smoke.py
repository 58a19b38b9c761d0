#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. Device: the card's name and power limit, the CUDA kernels built from
   ``src/repro_torch/kernels/csrc`` (build seconds), TF32 off.
2. Kernels against their plain PyTorch versions on the card, at the
   paths' shapes and at the edge cases; each kernel timed (CUDA events,
   median of 100 launches, L2 flushed before each) beside its plain
   version, one PyTorch library call and its bound.
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
   accumulation of the same chunks.
7. Kernel records as JSON, then the result line.

Needs one CUDA card, ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``) and
``nvidia-smi``.  Without a card it exits 1 before printing any result.
"""
from __future__ import annotations

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

from repro_torch.configs.lenet_mnist import LeNetConfig  # noqa: E402
from repro_torch.core import HFLProblem, plan  # noqa: E402
from repro_torch.data import size_partition, synthetic_mnist  # noqa: E402
from repro_torch.fl.aggregate import StreamingEdgeAccumulator  # noqa: E402
from repro_torch.fl.flatten import tree_leaves  # noqa: E402
from repro_torch.fl.sim import HFLSimulator  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import hier_aggregate as ha  # noqa: E402
from repro_torch.models.lenet import lenet_init, lenet_loss  # noqa: E402

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

KERNELS = {
    "segment_aggregate": dict(
        source="src/repro_torch/kernels/csrc/segment_aggregate.cu",
        replaces="src/repro/kernels/hier_aggregate.py:182"),
    "cloud_aggregate": dict(
        source="src/repro_torch/kernels/csrc/cloud_aggregate.cu",
        replaces="src/repro/kernels/hier_aggregate.py:117"),
    "segment_sum": dict(
        source="src/repro_torch/kernels/csrc/segment_sum.cu",
        replaces="src/repro/kernels/hier_aggregate.py:263"),
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


# ---------------------------------------------------------------------------
# Phase 1
# ---------------------------------------------------------------------------


def phase_device() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    paths = build.build()
    print(f"built {', '.join(paths)} in {time.perf_counter() - t0:.2f} s")
    for name, path in paths.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off: cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False")


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
            ("past_tpu_split_n1000", 1000, 1000, 5, None),
            ("ragged_f1001", 100, 1001, 5, None),
            ("bf16_main", 100, 44_426, 5, "bf16"),
            ("edge_without_members", 100, 1001, 6, "empty"),
            ("edge_all_zero_weight", 100, 1001, 5, "zero")]:
        x = torch.from_numpy(rng.normal(0, 1, (n, f)).astype(np.float32))
        w = torch.from_numpy(rng.uniform(200, 1000, n).astype(np.float32))
        g = torch.from_numpy((np.arange(n) % 5).astype(np.int32))
        if edit == "bf16":
            x = x.to(torch.bfloat16)
        if edit == "zero":
            w[g == 2] = 0.0
        cases[name] = (x.to(device), w.to(device), g.to(device), m)
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
        torch.cuda.synchronize()
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


def time_kernels(x, w, g, m) -> dict:
    """Kernel, plain-version and library times at the main path's shape,
    and the kernel's bound from this input's bytes and operations."""
    flush = torch.empty(256 * 2**20 // 4, device=x.device)   # > 50 MB L2
    n, f = x.shape
    p_seg = averaging_operator(w, g, m)
    p_cloud = averaging_operator(w, None, m)
    for p, ref in ((p_seg, ha.segment_aggregate_plain(x, w, g, m)),
                   (p_cloud, ha.cloud_aggregate_plain(x, w))):
        check(_max_err(torch.mm(p, x), ref)
              <= KERNEL_RTOL * float(ref.abs().max()),
              "torch.mm with the averaging operator computes the event")
    fns = {
        "segment_aggregate": (lambda: ha.segment_aggregate(x, w, g, m),
                              lambda: ha.segment_aggregate_plain(x, w, g, m),
                              lambda: torch.mm(p_seg, x), 2),
        "cloud_aggregate": (lambda: ha.cloud_aggregate(x, w),
                            lambda: ha.cloud_aggregate_plain(x, w),
                            lambda: torch.mm(p_cloud, x), 1),
    }
    out = {}
    for name, (kernel, plain, library, side_inputs) in fns.items():
        nbytes = n * f * x.element_size() + n * f * 4 + side_inputs * n * 4
        flops = 2 * n * f
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / FP32_FLOPS_PER_S * 1e3
        out[name] = dict(
            ms=time_ms(kernel, flush), plain_ms=time_ms(plain, flush),
            library_ms=time_ms(library, flush),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        r = out[name]
        print(f"  {name:17s} kernel {r['ms'] * 1e3:8.2f} us   plain "
              f"{r['plain_ms'] * 1e3:8.2f} us   torch.mm "
              f"{r['library_ms'] * 1e3:8.2f} us   bound "
              f"{r['bound_ms'] * 1e3:6.2f} us ({r['bound_by']}, "
              f"{nbytes} B)")
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
            ("max_groups", 2000, 1001, ha.MAX_GROUPS, None)]:
        x = torch.from_numpy(rng.normal(0, 1, (n, f)).astype(np.float32))
        w = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32))
        g = torch.from_numpy(rng.integers(0, m, n).astype(np.int32))
        if edit == "bf16":
            x = x.to(torch.bfloat16)
        if edit == "empty":
            g = torch.from_numpy((np.arange(n) % (m - 1)).astype(np.int32))
        if edit == "zero":
            w[g == 2] = 0.0
        cases[name] = (x.to(device), w.to(device), g.to(device), m)
    return cases


def check_segment_sum_against_plain(cases) -> float:
    """``segment_sum`` on each case against its plain version, and exact
    zeros for a group without members or with only zero weights; returns
    the largest absolute error."""
    worst = 0.0
    for case, (x, w, g, m) in cases.items():
        out = ha.segment_sum(x, w, g, m)
        ref = ha.segment_sum_plain(x, w, g, m)
        torch.cuda.synchronize()
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
        print(f"  {'segment_sum':17s} {case:22s} max|err| {err:.3e} "
              f"(scale {scale:.3e}; {ha.segment_sum_slices(*x.shape)[0]} "
              "row slices)")
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
    ``torch.mm`` of the (M, N) weighted one-hot with the chunk."""
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
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * n * f / FP32_FLOPS_PER_S * 1e3
    r = dict(ms=time_ms(lambda: ha.segment_sum(x, w, g, m, out=acc), flush),
             plain_ms=time_ms(lambda: ha.segment_sum_plain(x, w, g, m),
                              flush),
             library_ms=time_ms(lambda: torch.mm(onehot, x), flush),
             bound_ms=max(bytes_ms, ops_ms),
             bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    print(f"  {'segment_sum':17s} N={n} F={f} M={m}: kernel "
          f"{r['ms'] * 1e3:8.2f} us   plain {r['plain_ms'] * 1e3:8.2f} us"
          f"   torch.mm {r['library_ms'] * 1e3:8.2f} us   bound "
          f"{r['bound_ms'] * 1e3:6.2f} us ({r['bound_by']}, {nbytes} B)")
    return r


def time_slice_rule(x, w, g, m) -> None:
    """``segment_sum`` with the slice count its rule picks
    (``hier_aggregate.BLOCKS_PER_SM``) against half and twice as many
    slices, on the same inputs, so that the rule is checked on every run."""
    flush = torch.empty(256 * 2**20 // 4, device=x.device)
    acc = torch.zeros(m, x.shape[1], device=x.device)
    n = x.shape[0]
    chosen = ha.segment_sum_slices(*x.shape)[0]
    times = []
    for slices in (chosen // 2, chosen, 2 * chosen):
        rows = -(-n // slices)
        split = (-(-n // rows), rows)
        with mock.patch.object(ha, "segment_sum_slices", lambda *_: split):
            times.append((split[0], time_ms(
                lambda: ha.segment_sum(x, w, g, m, out=acc), flush)))
    print("  segment_sum       slices: " + ", ".join(
        f"{s} -> {t * 1e3:.2f} us" for s, t in times)
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


def make_sim(sch, ue_data, device, noise=0.0, **kw):
    init = lenet_init(torch.Generator().manual_seed(0), LeNetConfig(),
                      device="cpu")
    if noise:
        gen = torch.Generator().manual_seed(1)
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
    ha.reset_launch_counts()
    t0 = time.perf_counter()
    res = sim.run(test, rounds=rounds, verbose=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(ha.launch_counts)
    print(f"main path: {run_s:.3f} s for {rounds} cloud rounds "
          f"({run_s / rounds:.3f} s per round, first-call warm-up included)")
    print(f"launches during the main path: {launches}")
    check(launches == {"segment_aggregate": sch.b * rounds,
                       "cloud_aggregate": rounds, "segment_sum": 0},
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


def profile_round(sim, test, top: int = 8) -> None:
    """Where a warm cloud round's device time goes (``torch.profiler``):
    device-busy share of the wall time, the aggregation kernels' share,
    and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        sim.run(test, rounds=1)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not kernels:
        print("profiled round: the profiler recorded no device time")
        return
    agg_us = sum(e.self_device_time_total for e in kernels
                 if "aggregate_kernel" in e.key)
    print(f"profiled round: {wall_us / 1e6:.3f} s wall (profiler on), "
          f"device busy {busy_us / 1e6:.3f} s = {busy_us / wall_us:.1%}; "
          f"aggregation kernels {agg_us / 1e3:.3f} ms = "
          f"{agg_us / busy_us:.2%} of device time; "
          f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")


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
    ha.reset_launch_counts()
    t0 = time.perf_counter()
    res = sim.run(test, rounds=ROUNDS, verbose=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(ha.launch_counts)
    tl = res.timeline
    waves = departure_waves(tl)
    updates = len(tl.updates)
    print(f"async path: max_staleness={ASYNC_STALENESS}, {ROUNDS} rounds' "
          f"quota = {updates} cloud updates, {waves} departure waves")
    print(f"launches during the async path: {launches}")
    check(launches == {"segment_aggregate": sch.b * waves,
                       "cloud_aggregate": 0, "segment_sum": 0},
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
    ha.reset_launch_counts()
    t0 = time.perf_counter()
    for i, start in enumerate(starts):
        stop = min(start + chunk, n)
        acc.add(stream_chunk(i, stop - start), w[start:stop],
                gid[start:stop])
    means = acc.edge_means()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ha.launch_counts)
    print(f"streaming: {n} rows x {f} fp32 in {len(starts)} chunks of "
          f"{chunk}, M={m}: {wall:.3f} s, {n / wall:.4g} rows/s (chunk "
          f"generation included); resident {acc.resident_bytes()} B, "
          f"chunk {chunk * f * 4} B, full buffer avoided {n * f * 4} B")
    print(f"launches during the streaming path: {launches}")
    check(launches == {"segment_aggregate": 0, "cloud_aggregate": 0,
                       "segment_sum": len(starts)},
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
    return launches["segment_sum"]


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    print("== phase 1: device")
    phase_device()

    print("== phase 2: kernels vs plain versions on the card")
    cases = kernel_cases("cuda")
    errs = check_kernels_against_plain(cases)
    timing = time_kernels(*cases["main_n100_f44426"])
    s_cases = sum_cases("cuda")
    errs["segment_sum"] = check_segment_sum_against_plain(s_cases)
    timing["segment_sum"] = time_segment_sum(*s_cases["stream_n8192_f1024"])
    time_slice_rule(*s_cases["stream_n8192_f1024"])
    time_segment_sum(*s_cases["lenet_n100_f44426"])
    del cases, s_cases

    print("== phase 3: main path at full width")
    sch, plan_s, ue_data, test = main_path_inputs()
    launches = phase_main_path(sch, plan_s, ue_data, test)

    print("== phase 4: the card against the CPU, one cloud round")
    card_sync, spread = phase_card_vs_cpu(sch, ue_data, test)

    print("== phase 5: async Algorithm 1 at full width")
    phase_async(sch, ue_data, test, card_sync, spread)

    print("== phase 6: streaming edge aggregation, 1,048,576 rows")
    launches["segment_sum"] = phase_streaming()

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
