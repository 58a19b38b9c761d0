"""The measured window: a closed loop of units (rounds, requests, decode
steps), each ending when its result is in host memory."""
from __future__ import annotations

import time

from harness import trace as tr


def closed_loop(unit, seconds: float, profile=None, spans=(),
                ready=None) -> dict:
    """Run ``unit()`` one after another until ``seconds`` have passed on
    the host clock; the window ends with the unit that crosses it, so it
    holds whole units only.  Returns the window's length, the count of
    units and each unit's host seconds (from the previous unit's end).

    With ``profile`` (a function that runs a bounded slice of units), the
    first unit boundary past the window's middle (where ``ready()``, if
    given, is true) runs that slice under the profiler instead
    (``trace.profile_slice``); its time is kept out of ``unit_s`` and its
    summary is returned as ``trace``."""
    t0 = last = time.perf_counter()
    unit_s, summary = [], None
    while True:
        if profile is not None and summary is None \
                and last - t0 >= seconds / 2 and (ready is None or ready()):
            summary = tr.profile_slice(profile, spans)
            last = time.perf_counter()
            if last - t0 >= seconds:
                break
            continue
        unit()
        now = time.perf_counter()
        unit_s.append(now - last)
        last = now
        if now - t0 >= seconds:
            break
    if profile is not None and summary is None:
        summary = tr.profile_slice(profile, spans)
    return {"window_s": last - t0, "units": len(unit_s), "unit_s": unit_s,
            "trace": summary}
