"""``moe_issue_ms.decode``: host milliseconds a decode step spends issuing
the MoE FFN (``apply_moe`` in ``repro_torch/models/moe.py``, every layer):
the host seconds of the program's ``moe`` spans over its
``model.decode_step`` spans, in the profiled steps.  The spans' own host
time is kept out; the profiler's cost per recorded operation is not, so
the share of the step (``moe_issue_share.decode``) is the number to set
beside the untraced ``issue_ms.decode``."""
from harness.program import host_per_unit


def read(rec):
    s = host_per_unit("moe", "model.decode_step")
    return None if s is None else 1e3 * s
