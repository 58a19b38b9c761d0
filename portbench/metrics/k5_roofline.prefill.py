"""``k5_roofline.prefill``: K5 in bf16 (``flash_attention_bf16``) against
its roofline: the frozen bound of one causal launch at the request's
shapes over the mean device time of a recorded launch."""
from costs import kernels as kc
from harness.trace import kernel_times_us


def read(rec):
    t = kernel_times_us(rec.get("trace"), "flash_attention_kernel_bf16")
    if not t:
        return None
    c = rec["sizes"]
    flops, nbytes = kc.flash_attention(
        rec["batch"], rec["prompt_len"], c["num_attention_heads"],
        c["num_key_value_heads"], c["head_dim"])
    return 100.0 * kc.bound_s(flops, nbytes, "bfloat16") / (sum(t) / len(t)
                                                            / 1e6)
