"""Arithmetic on measured times: the union of device intervals, a
percentile over all samples.  Plain Python, so the tests hold it to
hand-reckoned values."""
from __future__ import annotations

import statistics


def union_length(intervals, lo=None, hi=None) -> float:
    """Length of the union of ``(start, end)`` intervals, each clipped to
    ``[lo, hi]`` where given.  Overlapping intervals count once (a sum of
    durations would count them twice)."""
    spans = []
    for s, e in intervals:
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e > s:
            spans.append((s, e))
    spans.sort()
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps_between(intervals, lo, hi):
    """The idle gaps ``(start, end)`` inside ``[lo, hi]`` that no interval
    covers, in time order."""
    spans = sorted((max(s, lo), min(e, hi)) for s, e in intervals
                   if min(e, hi) > max(s, lo))
    out, t = [], lo
    for s, e in spans:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0 < q < 100) of all ``values``, linear
    between order statistics (``statistics.quantiles``' inclusive
    method)."""
    values = list(values)
    if len(values) == 1:
        return float(values[0])
    cuts = statistics.quantiles(values, n=1000, method="inclusive")
    return float(cuts[int(round(q * 10)) - 1])
