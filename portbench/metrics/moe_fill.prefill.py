"""``moe_fill.prefill``: percent of the capacity rows the expert products
compute that carry a token: the program's ``moe.picks_kept`` (picks
within their expert's C rows, from ``_dispatch``'s ``keep``) over its
``moe.rows_computed`` (E·C a call), in the profiled requests."""
from harness.program import counters


def read(rec):
    c = counters()
    rows, kept = c.get("moe.rows_computed"), c.get("moe.picks_kept")
    if not rows or kept is None:
        return None
    return 100.0 * kept / rows
