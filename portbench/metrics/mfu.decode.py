"""``mfu.decode``: a decode step's share of its roofline: the larger of
its FLOPs over the bf16 peak and its bytes over the HBM rate (the weights
outside the routed experts, the experts the step's tokens picked, the
counted K/V slots and the new K/V) over the mean inter-token gap outside
the profiled slice (a decode step's host seconds; a fresh batch's prefill
is in no gap).  Decode is bound by bytes, so a share of the
FLOP peak alone would bound no gain."""
from costs import kernels as kc
from costs import models as cm


def read(rec):
    times = rec.get("gaps_s") or []
    counted = rec.get("slice_counted") or []
    picked = rec.get("experts_picked")
    if not times or not counted or not picked:
        return None
    c, b = rec["sizes"], rec["batch"]
    bound = sum(kc.bound_s(cm.decode_flops(c, b, n),
                           cm.decode_bytes(c, b, n, picked), "bfloat16")
                for n in counted) / len(counted)
    return 100.0 * bound / (sum(times) / len(times))
