"""What each kernel launch costs, handed to the cost walks that are running.

A kernel launched through ``ctypes`` is no aten op: no dispatch mode sees
it, so a walk that counts aten ops (``repro_torch.roofline.cost``) would
count none of its work.  Each wrapper therefore calls ``record`` where it
counts a launch, with its cost function (``flash_attention_cost``,
``decode_attention_cost``, ``rglru_scan_cost`` and the four in
``hier_aggregate``): FLOPs and bytes per launch, the same reckoning as
the bounds ``chip_smoke.py`` prints.  With no walk running, ``record``
does nothing and costs nothing.

Under ``FakeTensorMode`` (the dry run, ``repro_torch.launch.dryrun``) a
wrapper given fake tensors launches nothing: ``fake_launch`` records the
cost of the launch it stands for, from shapes alone, and the wrapper
returns an (equally fake) output of the launch's shape.
"""
from __future__ import annotations

#: The walks running now, innermost last.  Each takes
#: ``kernel(name, flops, nbytes)``.
walks: list = []


def is_fake(t) -> bool:
    """Whether ``t`` is a ``FakeTensor`` (no storage, nothing to launch on)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def fake_launch(name: str, cost, out, *args, **kw):
    """Stand for one launch of kernel ``name`` on fake tensors: its cost
    handed to the running walks, marked as launched by no wrapper, and
    ``out`` returned."""
    record(name, cost, *args, fake=True, **kw)
    return out


def record(name: str, cost, *args, fake: bool = False, **kw) -> None:
    """Hand ``cost(*args, **kw) -> (flops, nbytes)`` of one launch of
    kernel ``name`` to every running walk.  The cost is computed outside
    the walks' own counting (no dispatch mode sees its ops)."""
    if not walks:
        return
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        flops, nbytes = cost(*args, **kw)
    for walk in walks:
        walk.kernel(name, float(flops), float(nbytes), fake=fake)
