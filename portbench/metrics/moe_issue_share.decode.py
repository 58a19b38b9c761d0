"""``moe_issue_share.decode``: percent of a decode step's host issue that
goes to the MoE FFN (``apply_moe`` in ``repro_torch/models/moe.py``, every
layer): the host seconds of the program's ``moe`` spans over those of its
``model.decode_step`` spans, in the profiled steps.  Both are taken under
the profiler's own cost per operation and net of the spans' own, so the
share holds where the traced milliseconds (``moe_issue_ms.decode``) run
above the untraced step's."""
from harness.program import host_per_unit


def read(rec):
    moe = host_per_unit("moe", "model.decode_step")
    step = host_per_unit("model.decode_step", "model.decode_step")
    return None if moe is None or not step else 100.0 * moe / step
