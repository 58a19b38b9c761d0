"""The profiled slice of a traced run, and what the readers take from it.

A ``--trace 1`` run profiles a bounded slice of its window (one round,
one request, a few decode steps) with ``torch.profiler`` (CUPTI), and
keeps from it, in memory, only:

* ``kernels``: every device operation's ``(name, start_us, end_us)``
  (kernels, copies, fills), the harness's own annotations left out;
* ``spans``: for each ``record_function`` range the harness put around a
  call into a layer (names starting ``pb.``), each occurrence's
  ``(start_us, end_us, device_us)``: its ends on the host and the device
  time of the kernels launched inside it from the calling thread;
* ``lo``/``hi``: the slice's ends on the same clock.

No Chrome trace is written.  The profiler is known to drop whole
sessions now and then, so a slice that records no device operation, or
none of a required span, is profiled again.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

from harness.stats import gaps_between, union_length

SLICE = "pb.slice"
NAME_CHARS = 100


def _device_time(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def summarise(events) -> dict:
    """The slice's kernels, spans and ends from ``prof.events()``."""
    from torch.autograd import DeviceType
    lo = hi = None
    kernels, spans, host = [], defaultdict(list), []
    for e in events:
        name = e.name
        if e.device_type == DeviceType.CPU:
            if name == SLICE:
                lo, hi = e.time_range.start, e.time_range.end
            elif name.startswith("pb."):
                spans[name].append((e.time_range.start, e.time_range.end,
                                    _device_time(e)))
            else:
                host.append((e.time_range.start, e.time_range.end, name))
        elif not name.startswith("pb."):
            kernels.append((name, e.time_range.start, e.time_range.end))
    return {"lo": lo, "hi": hi, "kernels": kernels, "spans": dict(spans),
            "host": host}


def profile_slice(fn, required_spans=(), attempts: int = 3) -> dict:
    """Run ``fn()`` under the profiler inside a ``pb.slice`` range that
    ends after a device synchronise; return ``summarise`` of it.  A
    session that recorded no device operation, or not every one of
    ``required_spans``, is run again (``fn`` runs once more each time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    summary = None
    for _ in range(attempts):
        sync()
        with profile(activities=acts) as prof:
            with record_function(SLICE):
                fn()
                sync()
        summary = summarise(prof.events())
        if (summary["kernels"] and summary["lo"] is not None
                and all(s in summary["spans"] for s in required_spans)):
            return summary
    return summary


def busy_window_s(tr: dict) -> tuple:
    """(seconds in which some device operation ran, seconds of the slice):
    the union of the device intervals inside the slice."""
    busy = union_length([(s, e) for _, s, e in tr["kernels"]],
                        tr["lo"], tr["hi"])
    return busy / 1e6, (tr["hi"] - tr["lo"]) / 1e6


def idle_share(tr) -> float:
    """Percent of the slice in which no device operation ran, or None."""
    if not tr or not tr.get("kernels") or tr.get("lo") is None:
        return None
    busy, window = busy_window_s(tr)
    if window <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / window)


def span_device_us(tr, name: str) -> float:
    """Device microseconds of the kernels launched inside the ``name``
    ranges from the calling thread, summed over the slice; None if the
    slice has no such range."""
    spans = (tr or {}).get("spans", {}).get(name)
    return sum(d for _, _, d in spans) if spans else None


def span_union_us(tr, name: str) -> float:
    """Device microseconds in which some operation ran inside the
    ``name`` ranges' ends, summed over the ranges: the whole device work
    of a range that synchronises the device at its start and before its
    end (kernels launched from other threads too, such as autograd's);
    None if the slice has no such range."""
    spans = (tr or {}).get("spans", {}).get(name)
    if not spans:
        return None
    iv = [(s, e) for _, s, e in tr["kernels"]]
    return sum(union_length(iv, lo, hi) for lo, hi, _ in spans)


def kernel_times_us(tr, substring: str) -> list:
    """Device durations (us) of the recorded launches whose name holds
    ``substring``."""
    if not tr:
        return []
    return [e - s for name, s, e in tr["kernels"] if substring in name]


#: Name pieces of the program's hand-written kernels (``kernels/csrc``).
OWN = ("segment_aggregate_kernel", "cloud_aggregate_kernel",
       "weighted_mean", "segment_sum", "flash_attention_kernel",
       "decode_attention", "rglru")


def own_kernels(tr) -> dict:
    """{kernel: (launches recorded, mean device us)} of the program's
    hand-written kernels in the slice."""
    out = {}
    for piece in OWN:
        t = kernel_times_us(tr, piece)
        if t:
            out[piece] = (len(t), round(sum(t) / len(t), 3))
    return out


def _label_gaps(gaps, host):
    """What the host was doing at each gap's start: the innermost host
    event (the latest-starting one still running), else ``host: between
    ops`` (Python between two recorded calls, or waiting)."""
    host = sorted(host)
    starts = [h[0] for h in host]
    out = []
    for g0, g1 in gaps:
        label = "host: between ops"
        i = bisect.bisect_right(starts, g0) - 1
        for j in range(i, max(i - 500, -1), -1):
            if host[j][1] >= g0:
                label = host[j][2]
                break
        out.append((label, (g1 - g0) / 1e6))
    return out


def breakdown(tr, top: int = 10) -> dict:
    """The device operations that took most time in the slice, and the
    idle gaps summed by what the host was doing, at most ``top`` each,
    in seconds."""
    if not tr or not tr.get("kernels") or tr.get("lo") is None:
        return None
    ops = defaultdict(float)
    for name, s, e in tr["kernels"]:
        ops[name[:NAME_CHARS]] += (e - s) / 1e6
    gaps = gaps_between([(s, e) for _, s, e in tr["kernels"]],
                        tr["lo"], tr["hi"])
    idle = defaultdict(float)
    for label, sec in _label_gaps(gaps, tr["host"]):
        idle[label[:NAME_CHARS]] += sec
    order = lambda d: [[k, v] for k, v in
                       sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": order(ops), "idle_gaps": order(idle)}
