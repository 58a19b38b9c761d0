"""``gd_s.round``: device seconds of one round's local GD
(``repro_torch/fl/clients.py``), in the profiled round: the device time
inside the ``pb.gd`` ranges the harness wraps around the ``run`` that
``clients.gd_local_steps`` returns.  While profiling, each range starts
and ends with a device synchronise, so every kernel in it is GD's, the
backward's (launched from autograd's own thread) among them."""
from harness.trace import span_union_us


def read(rec):
    us = span_union_us(rec.get("trace"), "pb.gd")
    return us / 1e6 if us else None
