"""``agg_roofline.round``: K1 (eq. 6, ``segment_aggregate``) and K2
(eq. 10, ``cloud_aggregate``) of a round against their roofline: the
frozen bound of each launch's shapes (b K1 launches and one K2 on the
(N, F) fp32 buffer) over the mean device time of a recorded launch of
each, in the profiled round."""
from costs import kernels as kc
from harness.trace import kernel_times_us


def read(rec):
    tr = rec.get("trace")
    t1 = kernel_times_us(tr, "segment_aggregate_kernel")
    t2 = kernel_times_us(tr, "cloud_aggregate_kernel")
    if not t1 or not t2:
        return None
    n, f, b = rec["num_ues"], rec["params"], rec["b"]
    bound = (b * kc.bound_s(*kc.segment_aggregate(n, f), "float32")
             + kc.bound_s(*kc.cloud_aggregate(n, f), "float32"))
    spent = (b * sum(t1) / len(t1) + sum(t2) / len(t2)) / 1e6
    return 100.0 * bound / spent
