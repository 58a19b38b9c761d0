"""``experts_ms.prefill``: device milliseconds of a request in the MoE's
expert products (``_expert_ffn`` in ``repro_torch/models/moe.py``, dense
over all E·C capacity rows): the operations the host queued inside the
program's ``moe.experts`` ranges, over the slice's ``model.prefill``
ranges."""
from harness.program import device_per_unit


def read(rec):
    s = device_per_unit(rec, "moe.experts", "model.prefill")
    return None if s is None else 1e3 * s
