"""``local_gd_s.round``: device seconds of a round's local GD: the
operations the host queued inside the program's ``hfl.local_gd`` ranges
(``repro_torch/fl/sim.py``, each around the ``_local_gd`` call of an edge
iteration; the backward kernels autograd queues from its own thread
too), over the slice's ``hfl.round`` ranges."""
from harness.program import device_per_unit


def read(rec):
    return device_per_unit(rec, "hfl.local_gd", "hfl.round")
