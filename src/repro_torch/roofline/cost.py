"""Cost walk of one step, run on its device: the port's counterpart of the
JAX package's ``repro/roofline/hlo_cost.py``.

The reference compiles a step and walks its post-SPMD HLO text,
multiplying loop bodies by their trip counts.  The port has no compiled
program to read: ``analyze`` RUNS the step once, for real, on the device
its tensors lie on, and counts what ran.  A Python loop over layers or
steps runs each trip, so there are no trip counts to resolve.

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (matrix products,
  convolutions, attention), where the reference counts dot and
  convolution ops.
* bytes: operand bytes plus result bytes of every aten op.  Views,
  aliases and metadata ops are free (``view``, ``expand``, ``t``,
  ``detach``, ``alias``, ``as_strided`` and every other view;
  ``_unsafe_view``, which copies nothing; allocations; size and stride
  queries), as ``_FREE_OPS`` are in the reference.  Eager PyTorch runs
  each aten op as its own kernel, one round trip through HBM: this is the
  port's counterpart of the reference's one round trip a fusion.  Like
  the reference's, the count is an upper bound (an in-place op's target
  counts as read and written, a broadcast operand at its full size).
* collectives: the c10d ops by kind and by the bytes of their results, as
  ``torch.distributed.tensor.debug.CommDebugMode`` finds them.  On one
  rank there are none.
* the hand-written kernels: launched through ``ctypes``, they are no aten
  op and no dispatch mode sees them.  Each wrapper hands the walk its
  launch's cost (``repro_torch.kernels.costs``; the reckoning of the
  kernels' bounds), and the walk raises if a kernel's launch count
  (``repro_torch.tracing.launches``) rose without a cost recorded.  The
  reference counts no FLOPs for its Pallas custom calls; the port counts
  its kernels.

On the CPU the wrappers take their plain versions, which are aten ops and
counted as such.

On DTensors (a sharded step, ``Model(mesh=)``) the walk counts ONE RANK's
work, as the reference's HLO walk counts one device's: it lets each
DTensor op through uncounted (a DTensor argument) and counts the local ops
and collectives the DTensor runs for this rank; the ops DTensor's sharding
propagation runs on global shapes, to learn an output's shape, are not
counted.  The FLOPs come from ``torch.utils.flop_counter``'s formulas
(``flop_registry``), as ``FlopCounterMode`` counts them.  Under
``FakeTensorMode`` (the dry run, ``launch/dryrun.py``) nothing runs and
the counts are the same.
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch import tracing
from repro_torch.kernels import costs

#: The reference's collective kinds, each reported (0 when none ran).
COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")
_COLL_OPS = {
    "all-reduce": ("allreduce_", "allreduce_coalesced_", "all_reduce",
                   "all_reduce_coalesced"),
    "all-gather": ("allgather_", "_allgather_base_", "allgather_coalesced_",
                   "allgather_into_tensor_coalesced_",
                   "all_gather_into_tensor",
                   "all_gather_into_tensor_coalesced"),
    "reduce-scatter": ("reduce_scatter_", "_reduce_scatter_base_",
                       "reduce_scatter_tensor_coalesced_",
                       "reduce_scatter_tensor",
                       "reduce_scatter_tensor_coalesced"),
    "all-to-all": ("alltoall_", "alltoall_base_", "all_to_all_single"),
    "collective-permute": ("send", "recv_"),
    # no counterpart in the reference's HLO (the service's
    # broadcast_object_list); reported when it runs
    "broadcast": ("broadcast_", "broadcast"),
}
_COLL_OF = {op: kind for kind, ops in _COLL_OPS.items() for op in ops}
_COLL_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")

#: Ops that move no data besides the views (``OpOverload.is_view``).
_FREE_OPS = {"_unsafe_view", "empty", "empty_like", "empty_strided",
             "new_empty", "new_empty_strided", "lift_fresh", "sym_size",
             "sym_stride", "sym_numel", "sym_storage_offset"}

def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _has_dtensor(tree) -> bool:
    """Whether ``tree`` holds a DTensor (its op is the global one)."""
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:                               # no torch.distributed
        return False
    return any(isinstance(t, DTensor) for t in tree_leaves(tree))


#: > 0 while DTensor's sharding propagation runs an op on global shapes.
_PAUSED = [0]


@contextlib.contextmanager
def _pause_sharding_propagation():
    """Mark the ops DTensor runs to propagate an output's shape (global
    shapes, not this rank's work) as not counted.  Raises where this
    torch's DTensor has no such hook: the walk would count global FLOPs
    as one rank's."""
    if not torch.distributed.is_available():          # no DTensors to walk
        yield
        return
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = "_propagate_tensor_meta_non_cached"
    orig = ShardingPropagator.__dict__.get(name)
    if orig is None:
        raise RuntimeError(
            f"torch {torch.__version__}: DTensor's ShardingPropagator has no "
            f"{name}; the cost walk cannot tell its shape propagation from "
            "a rank's work")
    if getattr(orig, "_paused", False):
        yield
        return

    @functools.wraps(orig)
    def paused(self, *a, **k):
        _PAUSED[0] += 1
        try:
            return orig(self, *a, **k)
        finally:
            _PAUSED[0] -= 1
    paused._paused = True
    setattr(ShardingPropagator, name, paused)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


#: Size and stride queries, which ``FlopCounterMode`` passes over.
_QUERIES = {"is_contiguous", "sym_is_contiguous", "is_strides_like_format",
            "is_non_overlapping_and_dense", "size", "sym_size", "stride",
            "sym_stride", "storage_offset", "sym_storage_offset", "numel",
            "sym_numel", "dim", "layout"}


class _FlopCounter(TorchDispatchMode):
    """FLOPs of every op with a formula in ``flop_registry``, as
    ``FlopCounterMode`` counts them (an op without one is decomposed where
    it can be); a DTensor op is let through to its local ops."""

    def __init__(self, walk: "CostWalk"):
        super().__init__()
        self.walk = walk

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _has_dtensor((args, kwargs)):
            return NotImplemented
        if func.name().partition("::")[2].split(".")[0] in _QUERIES:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if (packet not in flop_registry
                and func is not torch.ops.prim.device.default):
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        if packet in flop_registry and not _PAUSED[0]:
            self.walk.flops += flop_registry[packet](*args, **kwargs,
                                                     out_val=out)
        return out


class _ByteCounter(TorchDispatchMode):
    """Bytes of every aten op and the collectives, into ``walk``."""

    def __init__(self, walk: "CostWalk"):
        super().__init__()
        self.walk = walk

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _has_dtensor((args, kwargs)):
            return NotImplemented
        out = func(*args, **kwargs)
        if _PAUSED[0]:
            return out
        namespace, _, name = func.name().partition("::")
        if func.is_view or name in _FREE_OPS:
            return out
        self.walk.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        if namespace in _COLL_NAMESPACES and name in _COLL_OF:
            moved = _tensor_bytes(out) or _tensor_bytes(args[:1])
            kind = _COLL_OF[name]
            self.walk.coll[kind] = self.walk.coll.get(kind, 0.0) + moved
            self.walk.coll_ops += 1
        return out


class CostWalk:
    """Counts the FLOPs, bytes, collectives and kernel launches of what runs
    inside ``with CostWalk() as w:``; ``w.result()`` after it (the keys of
    ``analyze``).  Raises on leaving if a kernel wrapper counted a launch
    without recording its cost."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0.0
        self.coll = {kind: 0.0 for kind in COLL_KINDS}
        self.coll_ops = 0
        self.kernels: dict = {}
        self._fake: dict = {}
        self._stack = None
        self._before = None

    def kernel(self, name: str, flops: float, nbytes: float,
               fake: bool = False) -> None:
        """One launch of kernel ``name`` (``kernels.costs.record``);
        ``fake``: one that fake tensors stood for (nothing launched)."""
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["launches"] += 1
        self._fake[name] = self._fake.get(name, 0) + int(fake)
        k["flops"] += flops
        k["bytes"] += nbytes

    def __enter__(self) -> "CostWalk":
        self._before = tracing.launches()
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(_pause_sharding_propagation())
        self._stack.enter_context(_FlopCounter(self))
        self._stack.enter_context(_ByteCounter(self))
        costs.walks.append(self)
        return self

    def __exit__(self, *exc) -> None:
        costs.walks.remove(self)
        self._stack.close()
        if exc[0] is not None:
            return
        after = tracing.launches()
        for name, n in after.items():
            launched = n - self._before.get(name, 0)
            counted = (self.kernels.get(name, {}).get("launches", 0)
                       - self._fake.get(name, 0))
            if launched != counted:
                raise RuntimeError(
                    f"cost walk: {name} launched {launched} times, its cost "
                    f"recorded {counted} times (a launch without "
                    "kernels.costs.record)")

    def result(self) -> dict:
        kf = sum(k["flops"] for k in self.kernels.values())
        kb = sum(k["bytes"] for k in self.kernels.values())
        out = {"flops": float(self.flops) + kf,
               "bytes": self.bytes + kb,
               "collective_bytes": float(sum(self.coll.values())),
               "collective_ops": self.coll_ops}
        for kind, moved in self.coll.items():
            out[f"coll_{kind}"] = float(moved)
        out["kernels"] = {name: dict(k) for name, k in self.kernels.items()}
        return out


def analyze(fn, *args, **kw) -> dict:
    """Run ``fn(*args, **kw)`` once, for real, and return its cost: the
    keys of the reference's ``hlo_cost.analyze`` (``flops``, ``bytes``,
    ``collective_bytes``, ``collective_ops``, ``coll_<kind>`` for each of
    ``COLL_KINDS``) and ``kernels``: each hand-written kernel launched,
    with its launches and the FLOPs and bytes they add to the totals."""
    with CostWalk() as walk:
        fn(*args, **kw)
    return walk.result()
