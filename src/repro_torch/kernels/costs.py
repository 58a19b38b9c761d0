"""What each kernel launch costs, handed to the cost walks that are running.

A kernel launched through ``ctypes`` is no aten op: no dispatch mode sees
it, so a walk that counts aten ops (``repro_torch.roofline.cost``) would
count none of its work.  Each wrapper therefore calls ``record`` where it
counts a launch, with its cost function (``flash_attention_cost``,
``decode_attention_cost``, ``rglru_scan_cost`` and the four in
``hier_aggregate``): FLOPs and bytes per launch, the same reckoning as
the bounds ``chip_smoke.py`` prints.  With no walk running, ``record``
does nothing and costs nothing.
"""
from __future__ import annotations

#: The walks running now, innermost last.  Each takes
#: ``kernel(name, flops, nbytes)``.
walks: list = []


def record(name: str, cost, *args, **kw) -> None:
    """Hand ``cost(*args, **kw) -> (flops, nbytes)`` of one launch of
    kernel ``name`` to every running walk.  The cost is computed outside
    the walks' own counting (no dispatch mode sees its ops)."""
    if not walks:
        return
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        flops, nbytes = cost(*args, **kw)
    for walk in walks:
        walk.kernel(name, float(flops), float(nbytes))
