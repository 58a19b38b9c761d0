"""What the program records of itself while the harness profiles it.

* Its spans' host ranges in the profiled slice (``repro_torch.tracing``
  opens one a span, named as the span): the device operations the host
  queued inside a span's ranges are the span's device work.
* Its registry: span occurrences and host seconds, and the MoE's traced
  counters (rows and picks).  The registry adds up over every profiled
  session of the run (a slice the harness profiles again included), so a
  reader divides a span's seconds by the occurrences of its unit's span
  in the same records.

A tree of the program without those spans records none, and every reader
here then returns None."""
from __future__ import annotations

import bisect
import importlib
import re

from harness.stats import union_length

#: Host calls that queue one device operation each (a kernel, a copy or a
#: fill) on a stream.
QUEUES_ONE = re.compile(r"^cu(da)?(Launch(Cooperative)?Kernel\w*"
                        r"|Memcpy\w*Async\w*|Memset\w*Async\w*)$")


def _tracing():
    try:
        return importlib.import_module("repro_torch.tracing")
    except ImportError:
        return None


def host_per_unit(name: str, unit: str):
    """The host seconds of span ``name`` in the registry over the
    occurrences of span ``unit``; None where either is missing."""
    t = _tracing()
    if t is None:
        return None
    spans = t.spans()
    s, u = spans.get(name), spans.get(unit)
    if not s or not u or not u["count"]:
        return None
    return float(s["host_s"]) / u["count"]


def counters() -> dict:
    """The program's traced counters, {} where it has none."""
    t = _tracing()
    return {} if t is None else t.counters()


def queued_device_s(tr, name: str):
    """Device seconds of the operations the host queued inside the
    program's ``name`` ranges of the slice, or None where the slice has
    no such range.

    The i-th call that queues one operation (``QUEUES_ONE``, from any
    thread: autograd's backward too) started the i-th operation of the
    slice in start order: exactly so on one stream.  Where a library runs
    two streams at once (cuDNN in LeNet's local GD) operations can start
    out of that order inside a range, but the ranges read here begin and
    end where the work is joined; the correlation ids confirm the match on
    the card (``PERF.md`` §6).  In each range the union of the operations'
    intervals counts, so two that run at once count once."""
    host, ops = (tr or {}).get("host"), (tr or {}).get("kernels")
    if not host or not ops:
        return None
    ranges = [(s, e) for s, e, n in host if n == name]
    if not ranges:
        return None
    calls = sorted(s for s, _, n in host if QUEUES_ONE.match(n))
    ivs = sorted((s, e) for _, s, e in ops)
    total = 0.0
    for lo, hi in ranges:
        i0, i1 = bisect.bisect_left(calls, lo), bisect.bisect_right(calls, hi)
        total += union_length(ivs[i0:i1])
    return total / 1e6


def device_per_unit(rec, name: str, unit: str):
    """``queued_device_s`` of span ``name`` over the slice's ``unit``
    ranges; None where either is missing."""
    tr = rec.get("trace")
    n = sum(1 for _, _, u in (tr or {}).get("host") or () if u == unit)
    s = queued_device_s(tr, name)
    return None if s is None or not n else s / n
