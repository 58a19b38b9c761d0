"""``mfu.prefill``: a request's model FLOPs (every layer's products on
every prompt token, causal attention, the head on each row's last token)
over the mean host seconds of a request outside the profiled slice, as a
percent of the bf16 peak."""
from costs import kernels as kc
from costs import models as cm


def read(rec):
    times = rec.get("unit_s") or []
    if not times:
        return None
    flops = cm.prefill_flops(rec["sizes"], rec["batch"], rec["prompt_len"])
    sec = sum(times) / len(times)
    return 100.0 * flops / sec / kc.PEAKS["flops_per_s"]["bfloat16"]
