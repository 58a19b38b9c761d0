"""``launches.decode``: the runtime and driver calls that queue device
work (kernel, cooperative-kernel and graph launches, asynchronous copies
and fills) that the host makes inside the program's ``model.decode_step``
ranges of the profiled slice, over the slice's decode steps."""
import re

LAUNCH = re.compile(r"^cu(da)?(Launch(Cooperative)?Kernel\w*|GraphLaunch\w*"
                    r"|Memcpy\w*Async\w*|Memset\w*Async\w*)$")


def read(rec):
    host = (rec.get("trace") or {}).get("host") or []
    steps = len(rec.get("slice_counted") or [])
    ranges = [(s, e) for s, e, name in host if name == "model.decode_step"]
    if not ranges or not steps:
        return None
    calls = sum(1 for s, _, name in host if LAUNCH.match(name)
                and any(lo <= s <= hi for lo, hi in ranges))
    return float(calls) / steps
