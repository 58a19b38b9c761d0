"""``eval_s.round``: device seconds of a round's evaluation: the
operations the host queued inside the program's ``hfl.eval`` ranges
(``HFLSimulator._evaluate``: test loss and accuracy, the train loss over
every UE's samples, read to the host), over the slice's ``hfl.round``
ranges."""
from harness.program import device_per_unit


def read(rec):
    return device_per_unit(rec, "hfl.eval", "hfl.round")
