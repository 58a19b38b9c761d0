"""``mfu.round``: the FLOPs one cloud round of Algorithm 1 needs (a*b GD
steps on every UE's samples and the round's evaluation, counted from
LeNet's shapes) over the mean host seconds of a round outside the
profiled slice, as a percent of the fp32 peak (TF32 off)."""
from costs import kernels as kc
from costs import models as cm


def read(rec):
    times = rec.get("unit_s") or []
    if not times:
        return None
    flops = cm.hfl_round_flops(rec["model"], rec["num_ues"],
                               rec["samples_per_ue"], rec["a"], rec["b"],
                               rec["eval_samples"])
    sec = sum(times) / len(times)
    return 100.0 * flops / sec / kc.PEAKS["flops_per_s"]["float32"]
