"""Meshes of ``torch.distributed`` ranks: the transformer's, the
data-sharded flat buffer's and the SPMD backend's.

Counterpart of the JAX package's ``repro/launch/mesh.py`` (the axis names,
``make_production_mesh``, ``make_host_mesh``, ``make_agg_mesh``,
``make_fl_mesh``, ``mesh_axis_names``, ``data_axes``, ``num_chips``, and
the hardware constants: the H100's where the reference has a TPU v5e's).
A JAX mesh is one program over many devices (``shard_map``).  Here a
mesh is a set of ``torch.distributed`` ranks, one process each, and every
sharded function is called by every rank with its LOCAL slab
(multi-controller):

* ``make_agg_mesh``: each rank holds one slab of the flat ``(N, F_total)``
  buffer (whole edges' UE rows over ``data``, a column slab over
  ``model``);
* ``make_fl_mesh``: each rank is one UE of an ('edge', 'ue') grid
  (``repro_torch.fl.spmd``);
* ``make_host_mesh`` and ``make_production_mesh``: a
  ``torch.distributed.DeviceMesh`` over the ranks, on which the
  transformer's parameters and batches are DTensors
  (``repro_torch.parallel.sharding``).  The production mesh's 256 or 512
  ranks exist only as a ``fake`` process group in the dry run
  (``repro_torch.launch.dryrun``).

``run_ranks`` spawns such a set of ranks on one host (tests,
``chip_smoke.py``).  Nothing here touches the network: the ranks meet
through a ``FileStore`` in a temporary directory and talk over gloo, which
also takes CUDA tensors (several ranks may share one card, which NCCL
refuses).
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import resolve_device

# Canonical axis names, as in the reference.  'pod' is the cross-pod axis;
# 'data' is the in-pod data/FSDP axis; 'model' is the tensor-parallel axis.
POD_AXIS = "pod"
DATA_AXIS = "data"
MODEL_AXIS = "model"

# Logical axis names of the flat (N, F_total) aggregation buffer
# (repro_torch.fl.flatten): 'ue' is the leading client axis (maps onto
# DATA_AXIS), 'feat' the flattened feature axis (maps onto MODEL_AXIS).  The
# rules table in repro_torch.parallel.sharding binds them to mesh axes.
UE_AXIS = "ue"
FEAT_AXIS = "feat"

# H100 SXM5 constants (per GPU), the counterparts of the reference's TPU
# v5e constants: the roofline (``repro_torch.roofline``), its delay-model
# bridge (``core.schedule.plan_from_roofline``), the kernels' launch rules
# and ``chip_smoke.py``'s bounds read them.  Each is a peak from NVIDIA's
# H100 Tensor Core GPU data sheet (the DGX H100 sheet for the links), not
# a measurement.
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense bf16 on the tensor cores
PEAK_FLOPS_FP32 = 67e12           # FLOP/s, fp32 off the tensor cores (the
#                                   port keeps TF32 off)
HBM_BW = 3.35e12                  # bytes/s, HBM3
HBM_BYTES = 80e9                  # bytes
NUM_SMS = 132                     # streaming multiprocessors
# The links, in bytes/s EACH WAY (one direction's rate, what a transfer
# out of a GPU sees; the data sheets sum both directions):
NVLINK_BW = 450e9                 # NVLink 4 (900 GB/s a GPU, both ways
#                                   summed): the edge link, where the
#                                   reference has ICI_BW
IB_BW = 50e9                      # NDR InfiniBand, one 400 Gb/s
#                                   ConnectX-7 a GPU in a DGX H100: the
#                                   cloud link, where the reference has
#                                   DCN_BW


def _device_mesh(shape: tuple, axes: tuple, device):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production mesh: 16x16 = 256 ranks per pod; 2 pods = 512, axes
    ('data', 'model') or ('pod', 'data', 'model'), over the first ranks of
    the default process group (the dry run starts a ``fake`` group of
    them).  ``device``: the ranks' device type (``None``: the
    card; a ``fake`` group needs none)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = (POD_AXIS, DATA_AXIS, MODEL_AXIS) if multi_pod else (DATA_AXIS,
                                                                MODEL_AXIS)
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}, have {have} — the dry-run "
            "must start a fake process group of 512 ranks before building "
            "the mesh")
    dev = torch.device(device or "cuda")
    if have == n:
        return _device_mesh(shape, axes, dev)
    # more ranks than the mesh needs: the first prod(shape), as the
    # reference takes the first devices
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1, *, device=None):
    """A ('data', 'model') ``DeviceMesh`` over the ranks of the initialised
    default process group, whose world size must be ``data * model``; rank
    ``r`` sits at ``(r // model, r % model)``.  ``device=None`` is the card
    (raises without one); ``"cpu"`` for the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised default "
                           "process group (torch.distributed)")
    if dist.get_world_size() != data * model:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                         f"ranks, the process group has "
                         f"{dist.get_world_size()}")
    return _device_mesh((data, model), (DATA_AXIS, MODEL_AXIS),
                        resolve_device(device))


def mesh_axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def data_axes(mesh) -> tuple:
    """Axes over which the batch is sharded."""
    return tuple(a for a in mesh.mesh_dim_names if a in (POD_AXIS, DATA_AXIS))


def num_chips(mesh) -> int:
    return int(mesh.size())


@dataclasses.dataclass(frozen=True)
class AggMesh:
    """One rank's view of a ('data', 'model') mesh of ranks.

    Rank ``r`` sits at ``(r // num_model, r % num_model)``, the reference's
    device grid order.  ``data_group`` holds the ranks with this rank's
    model index (the cloud event's all-reduce runs over it),
    ``model_group`` those with its data index (they hold the other column
    slabs of the same rows)."""
    num_data: int
    num_model: int
    data_index: int
    model_index: int
    device: torch.device
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.num_data, MODEL_AXIS: self.num_model}

    @property
    def size(self) -> int:
        return self.num_data * self.num_model

    @property
    def rank(self) -> int:
        return self.data_index * self.num_model + self.model_index


def make_agg_mesh(num_model: int, num_data: int = 1, *, device=None,
                  timeout: Optional[datetime.timedelta] = None) -> AggMesh:
    """This rank's ('data', 'model') mesh over the default process group,
    whose world size must be ``num_data * num_model``.

    Every rank must call it, in the same order as its other group
    creations: each creates every subgroup, with the backend the caller
    initialised.  ``timeout`` bounds the subgroups' collectives (``None``:
    torch's default).  ``device=None`` is the card ``cuda:{rank %
    device_count}`` (and raises without one); ``"cpu"`` for the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("make_agg_mesh needs an initialised default "
                           "process group (torch.distributed)")
    world = dist.get_world_size()
    if world != num_data * num_model:
        raise ValueError(f"a {num_data} x {num_model} mesh needs "
                         f"{num_data * num_model} ranks, the process group "
                         f"has {world}")
    rank = dist.get_rank()
    d, m = divmod(rank, num_model)
    data_group = model_group = None
    for j in range(num_model):
        g = dist.new_group([i * num_model + j for i in range(num_data)],
                           timeout=timeout)
        if j == m:
            data_group = g
    for i in range(num_data):
        g = dist.new_group([i * num_model + j for j in range(num_model)],
                           timeout=timeout)
        if i == d:
            model_group = g
    return AggMesh(num_data=num_data, num_model=num_model, data_index=d,
                   model_index=m, device=_rank_device(device, rank),
                   data_group=data_group, model_group=model_group)


@dataclasses.dataclass(frozen=True)
class FLMesh:
    """One rank's view of an ('edge', 'ue') mesh of ranks: one UE a rank.

    Rank ``r`` is UE ``r % ues_per_edge`` of edge ``r // ues_per_edge``,
    the reference's device grid order.  ``ue_group`` holds the ranks of
    this rank's edge (the eq. 6 all-reduce runs over it), ``world_group``
    every rank (eq. 10 and DANE's global gradient)."""
    num_edges: int
    ues_per_edge: int
    edge_index: int
    ue_index: int
    device: torch.device
    ue_group: Any = None
    world_group: Any = None

    @property
    def shape(self) -> dict:
        return {"edge": self.num_edges, "ue": self.ues_per_edge}

    @property
    def size(self) -> int:
        return self.num_edges * self.ues_per_edge

    @property
    def rank(self) -> int:
        return self.edge_index * self.ues_per_edge + self.ue_index

    def local(self, x):
        """This rank's ``(1, ...)`` slab of a stacked ``(E*U, ...)`` tensor,
        array or nested dicts and lists of them, on the mesh's device."""
        if isinstance(x, dict):
            return {k: self.local(v) for k, v in x.items()}
        if isinstance(x, list):
            return [self.local(v) for v in x]
        return torch.as_tensor(x[self.rank:self.rank + 1],
                               device=self.device)


def make_fl_mesh(num_edges: int, ues_per_edge: int, *, device=None,
                 timeout: Optional[datetime.timedelta] = None) -> FLMesh:
    """This rank's ('edge', 'ue') mesh for the SPMD backend over the
    default process group, whose world size must be ``num_edges *
    ues_per_edge``.

    Every rank must call it, in the same order as its other group
    creations: each creates every edge's subgroup, then the world's, with
    the backend the caller initialised.  ``timeout`` bounds the subgroups'
    collectives (``None``: torch's default).  ``device=None`` is the card
    ``cuda:{rank % device_count}`` (and raises without one); ``"cpu"`` for
    the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("make_fl_mesh needs an initialised default "
                           "process group (torch.distributed)")
    world = dist.get_world_size()
    if world != num_edges * ues_per_edge:
        raise ValueError(f"a {num_edges} x {ues_per_edge} mesh needs "
                         f"{num_edges * ues_per_edge} ranks, the process "
                         f"group has {world}")
    rank = dist.get_rank()
    e, u = divmod(rank, ues_per_edge)
    ue_group = None
    for i in range(num_edges):
        g = dist.new_group([i * ues_per_edge + j
                            for j in range(ues_per_edge)], timeout=timeout)
        if i == e:
            ue_group = g
    world_group = dist.new_group(list(range(world)), timeout=timeout)
    return FLMesh(num_edges=num_edges, ues_per_edge=ues_per_edge,
                  edge_index=e, ue_index=u,
                  device=_rank_device(device, rank), ue_group=ue_group,
                  world_group=world_group)


def _rank_device(device, rank: int) -> torch.device:
    """``device`` resolved; the bare card is rank ``r``'s
    ``cuda:{r % device_count}``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


#: The functional collectives ``StagedCollectives`` stages.
_STAGED = {"all_reduce", "all_reduce_coalesced", "all_gather_into_tensor",
           "all_gather_into_tensor_coalesced", "reduce_scatter_tensor",
           "reduce_scatter_tensor_coalesced", "all_to_all_single",
           "broadcast"}


class StagedCollectives:
    """A context under which every functional collective (the
    ``_c10d_functional`` ops: DTensor's redistributions and
    ``parallel.sharding``'s ``psum``, ``all_gather``, ``all_to_all``) on a
    CUDA tensor runs on a copy in pinned host memory and completes before
    its result is copied back to the card.  Gloo, the one backend that
    lets several ranks share a card, crashes the process on some
    asynchronous collectives of CUDA tensors (an all-gather along a dim
    other than 0, a DTensor's gather over two mesh axes); on host tensors
    it runs them all.  The compute stays on the card."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return _staged(func, types, args, kwargs or {})

        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def _staged(func, types, args, kwargs):
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves, tree_map
    leaves = tree_leaves((args, kwargs))
    if any(isinstance(t, DTensor) for t in leaves):
        return NotImplemented                  # the DTensor's local ops next
    ns, _, name = func.name().partition("::")
    dev = next((t.device for t in leaves if isinstance(t, torch.Tensor)
                and t.device.type == "cuda"), None)
    if ns != "_c10d_functional" or name not in _STAGED or dev is None:
        return func(*args, **kwargs)

    def host(t):
        if not isinstance(t, torch.Tensor):
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return h.copy_(t)
    out = func(*tree_map(host, args), **tree_map(host, kwargs))
    wait = torch.ops._c10d_functional.wait_tensor
    return tree_map(lambda t: wait(t).to(dev) if isinstance(t, torch.Tensor)
                    else t, out)


#: A rank's start-up in ``run_ranks``, as ``time.time()`` stamps: its
#: function and arguments loaded (their modules imported), its card set
#: (the CUDA context made) and its process group joined.
rank_times: dict = {}


def _rank_main(rank, world, store_path, timeout_s, on_cuda, payload,
               results) -> None:
    try:
        with open(payload, "rb") as f:
            fn, args = pickle.load(f)
        rank_times["entered"] = time.time()
        if on_cuda:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        rank_times["device"] = time.time()
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        rank_times["group"] = time.time()
        try:
            # pickled here, by value: a tensor left to the queue's own
            # pickler would be shared by a file descriptor that dies with
            # this process
            out = pickle.dumps(fn(*args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:                   # reported to the parent, which
        results.put((rank, False, traceback.format_exc()))   # re-raises


def run_ranks(fn, world: int, *args, device=None,
              timeout_s: float = 300.0) -> list:
    """Run ``fn(*args)`` in ``world`` spawned ranks of a gloo process group
    and return their results, in rank order.

    ``fn`` must be importable (a module-level function, pickled by name),
    ``args`` picklable (they reach every rank by value, through a file in
    the temporary directory), and ``fn`` must return something picklable
    (numpy arrays, CPU tensors: they are copied, so they outlive the
    rank).  The ranks meet through a
    ``FileStore`` in a temporary directory; collectives time out after
    ``timeout_s``, and the whole run is cut there too: the ranks are
    killed and ``TimeoutError`` raised.  A
    rank's exception is re-raised here as ``RuntimeError`` with its
    traceback, after the other ranks are killed.  ``device`` is where the
    ranks run (``None``: the card, rank ``r`` on ``cuda:{r %
    device_count}``); on the card the kernels are built here first, so
    that the ranks do not race ``nvcc``."""
    on_cuda = resolve_device(device).type == "cuda"
    if on_cuda:
        from repro_torch.kernels import build
        build.build()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out, failed = {}, True
    with tempfile.TemporaryDirectory() as tmp:
        # fn and args reach the ranks through a file, by value: a spawned
        # child reads its Process object only after it has imported the
        # parent's main module, so a Process object larger than the pipe's
        # buffer would hold each start() until the rank before had
        # imported, and the ranks would start one after the other
        payload = os.path.join(tmp, "payload")
        with open(payload, "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, world, os.path.join(tmp, "store"), timeout_s, on_cuda,
            payload, results)) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while len(out) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{world - len(out)} of {world} ranks "
                                       f"gave no result in {timeout_s} s")
                try:
                    rank, ok, val = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank {dead[0][0]} died with exit "
                                           f"code {dead[0][1]}") from None
                    continue
                if not ok:
                    raise RuntimeError(
                        f"rank {rank} of {world} failed:\n{val}")
                out[rank] = pickle.loads(val)
            failed = False
        finally:
            for p in procs:
                p.join(timeout=0 if failed else 30)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [out[r] for r in range(world)]
