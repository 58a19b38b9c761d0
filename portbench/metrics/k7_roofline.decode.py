"""``k7_roofline.decode``: K7 in bf16 (``decode_attention_bf16``) against
its roofline: the frozen bound of a launch at each profiled step's
counted slots (the new token's position and every earlier one), averaged
over the steps, over the mean device time of a recorded launch."""
from costs import kernels as kc
from harness.trace import kernel_times_us


def read(rec):
    t = kernel_times_us(rec.get("trace"), "decode_attention_bf16_kernel")
    counted = rec.get("slice_counted") or []
    if not t or not counted:
        return None
    c = rec["sizes"]
    bounds = [kc.bound_s(*kc.decode_attention(
        rec["batch"], c["num_attention_heads"], c["num_key_value_heads"],
        c["head_dim"], n, rec["ring"]), "bfloat16") for n in counted]
    return 100.0 * (sum(bounds) / len(bounds)) / (sum(t) / len(t) / 1e6)
