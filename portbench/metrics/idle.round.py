"""``idle.round``: percent of the profiled slice in which no device
operation ran: one minus the union of the device intervals (kernels,
copies, fills; overlapping ones counted once) over the slice's length."""
from harness.trace import idle_share


def read(rec):
    return idle_share(rec.get("trace"))
