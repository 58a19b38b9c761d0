"""``moe_ms.prefill``: device milliseconds a request in the MoE FFN
(``repro_torch/models/moe.py``: route, dispatch, expert products, combine
and the shared experts), the kernels launched inside the ``pb.moe``
ranges the harness wraps around each layer's ``apply_moe``, in the
profiled request."""
from harness.trace import span_device_us


def read(rec):
    us = span_device_us(rec.get("trace"), "pb.moe")
    if not us:
        return None
    return us / 1e3
