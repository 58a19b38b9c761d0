"""``moe_ms.decode``: device milliseconds a decode step in the MoE FFN
(``repro_torch/models/moe.py``), the kernels inside the ``pb.moe`` ranges
around each layer's ``apply_moe``, over the profiled steps."""
from harness.trace import span_device_us


def read(rec):
    us = span_device_us(rec.get("trace"), "pb.moe")
    steps = len(rec.get("slice_counted") or [])
    if not us or not steps:
        return None
    return us / 1e3 / steps
