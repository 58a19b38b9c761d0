"""Meshes of ``torch.distributed`` ranks for the data-sharded flat buffer.

Counterpart of the JAX package's ``repro/launch/mesh.py`` (``DATA_AXIS``,
``MODEL_AXIS``, ``make_agg_mesh``).  A JAX mesh is one program over many
devices (``shard_map``).  Here a mesh is a set of ``torch.distributed``
ranks, one process each: every rank holds one slab of the flat
``(N, F_total)`` buffer (whole edges' UE rows over ``data``, a column slab
over ``model``), and every sharded function is called by every rank with
its LOCAL slab (multi-controller).

``run_ranks`` spawns such a set of ranks on one host (tests,
``chip_smoke.py``).  Nothing here touches the network: the ranks meet
through a ``FileStore`` in a temporary directory and talk over gloo, which
also takes CUDA tensors (several ranks may share one card, which NCCL
refuses).
"""
from __future__ import annotations

import dataclasses
import datetime
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

# Axis names of the flat (N, F_total) buffer's mesh, as in the reference:
# UE rows shard over 'data', feature columns over 'model'.
DATA_AXIS = "data"
MODEL_AXIS = "model"


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
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return AggMesh(num_data=num_data, num_model=num_model, data_index=d,
                   model_index=m, device=dev, data_group=data_group,
                   model_group=model_group)


def _rank_main(rank, world, store_path, timeout_s, on_cuda, fn, args,
               results) -> None:
    try:
        if on_cuda:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
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

    ``fn`` must be importable (a module-level function; ``spawn`` pickles
    it by name) and return something picklable (numpy arrays, CPU tensors:
    they are copied, so they outlive the rank).  The ranks meet through a
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
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, world, os.path.join(tmp, "store"), timeout_s, on_cuda, fn,
            args, results)) for r in range(world)]
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
