"""``dispatch_ms.prefill``: device milliseconds of a request in the MoE's
dispatch (``_dispatch`` in ``repro_torch/models/moe.py``: each pick's
capacity bin and the scatter of its token into it): the operations the
host queued inside the program's ``moe.dispatch`` ranges, over the
slice's ``model.prefill`` ranges."""
from harness.program import device_per_unit


def read(rec):
    s = device_per_unit(rec, "moe.dispatch", "model.prefill")
    return None if s is None else 1e3 * s
