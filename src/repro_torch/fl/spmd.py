"""SPMD backend — the HFL schedule as ``torch.distributed`` collectives,
ported from the JAX package's ``repro/fl/spmd.py``.

Mapping: UE -> one rank of an ('edge', 'ue') mesh
(``repro_torch.launch.mesh.make_fl_mesh``); edge aggregation (eq. 6) -> a
weighted all-reduce over the edge's ranks every ``a`` local steps; cloud
aggregation (eq. 10) -> a weighted all-reduce over every rank every
``a*b`` steps.  Each event ravels the UE's parameters into one vector, so
it is ONE all-reduce of ``F + 1`` floats (``psum_weighted_mean``), not one
per leaf.  No kernel runs here: the reference's round uses no Pallas
kernel either.

Parameters live in the STACKED layout (every leaf with a leading UE axis
of size E*U); under the port's multi-controller mesh each rank passes its
own UE's ``(1, ...)`` slab (``FLMesh.local``) and gets its slab back.
Each rank's replica drifts between aggregations (local-SGD semantics, as
Alg. 1).

``make_local_sgd_train_step`` is the same schedule for the transformer
substrate: an optimizer step on each rank's own gradient, the params
averaged over a ``launch.mesh.AggMesh``'s 'data' group at edge and cloud
boundaries.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.fl import clients
from repro_torch.fl.aggregate import psum_weighted_mean
from repro_torch.fl.flatten import (FlatLayout, tree_flatten, tree_leaves,
                                    tree_unflatten)


def stack_for_mesh(params, num_edges: int, ues_per_edge: int):
    """Replicate one parameter tree (nested dicts and lists) into the
    ``(E*U, ...)`` stacked layout (views of ``params``' leaves)."""
    n = num_edges * ues_per_edge
    paths, leaves = tree_flatten(params)
    return tree_unflatten(paths, [
        torch.as_tensor(v).unsqueeze(0).expand((n,) + tuple(v.shape))
        for v in leaves])


def make_hfl_cloud_round(loss_fn: Callable, mesh, *, a: int, b: int,
                         lr: float, solver: str = "gd",
                         dane_mu: float = 0.1):
    """ONE cloud round = b edge rounds x a local steps on this rank's UE,
    with the paper's aggregation points as all-reduces over the mesh's
    groups.

    Returns ``round(stacked_params, stacked_batch, weights)``: this
    rank's ``(1, ...)`` slabs of the stacked params (float32 leaves) and
    batch and its ``(1,)`` weight D_n, on any device (moved to the mesh's);
    returns the rank's ``(1, ...)`` params after the cloud event, every
    rank the same model.  Every rank of the mesh must call it together."""
    if solver not in ("gd", "dane"):
        raise ValueError(f"solver must be 'gd' or 'dane', got {solver!r}")
    local_gd = clients.gd_local_steps(loss_fn, a, lr)
    local_dane = clients.dane_local_steps(loss_fn, a, lr, mu_prox=dane_mu)
    dev = mesh.device

    def cloud_round(stacked_params: dict, stacked_batch: dict,
                    weights) -> dict:
        layout = FlatLayout.of(stacked_params)
        if any(dt != torch.float32 for dt in layout.dtypes):
            raise ValueError("the SPMD round takes float32 parameters")
        # one (1, F) buffer; the leaves are views of it, so local steps
        # write it in place and each event overwrites it
        buf = layout.ravel(_to(stacked_params, dev))     # a fresh copy
        p = layout.unravel(buf)
        batch = _to(stacked_batch, dev)
        w = torch.as_tensor(weights, dtype=torch.float32, device=dev)

        def wavg(group) -> None:
            buf.copy_(psum_weighted_mean(w[0] * buf[0], w[0], group)[None])

        for _ in range(b):
            if solver == "dane":
                g_bar = clients.global_gradient(loss_fn, p, batch, w,
                                                group=mesh.world_group)
                local_dane(p, batch, g_bar)          # Alg. 1 line 5
            else:
                local_gd(p, batch)
            wavg(mesh.ue_group)                      # eq. (6)
        wavg(mesh.world_group)                       # eq. (10)
        return p

    return cloud_round


def hfl_spmd_round(loss_fn: Callable, mesh, stacked_params: dict,
                   stacked_batch: dict, weights, *, a: int, b: int,
                   lr: float, solver: str = "gd") -> dict:
    """One-shot wrapper around ``make_hfl_cloud_round``."""
    fn = make_hfl_cloud_round(loss_fn, mesh, a=a, b=b, lr=lr, solver=solver)
    return fn(stacked_params, stacked_batch, weights)


def make_local_sgd_train_step(model, optimizer, *, mesh, a: int, b: int):
    """HFL-scheduled train step for the transformer substrate.

    Standard data-parallel training syncs gradients EVERY step; under the
    paper's schedule each data-parallel group (edge) lets replicas drift
    for ``a`` steps, averages params within the pod every ``a`` steps and
    across pods every ``a*b``: the per-step all-reduce over the slow axis
    becomes a 1/(a*b) amortized one.  ``plan_from_roofline`` optimizes
    (a, b) for this.

    Every step applies the rank's local (unsynced) gradient through
    ``optimizer``; ``sync="edge"`` then averages the params over the
    mesh's 'data' group, ``sync="cloud"`` over 'pod' and 'data' where the
    mesh has them (the port's meshes, one host, have no 'pod' axis), and
    ``None`` or ``"none"`` not at all.  Each average is ONE all-reduce of
    the raveled params (``FlatLayout``; ``psum_weighted_mean`` with unit
    weights), not one per leaf.  ``mesh`` is a
    ``repro_torch.launch.mesh.AggMesh``; every rank of a group must step
    together.  Returns ``step_fn(params, opt_state, batch, sync) ->
    (params, opt_state, metrics)``, writing params and state in place."""
    del a, b        # the caller's step index picks each step's ``sync``
    from repro_torch.launch.steps import value_and_grad

    axes = {"edge": ("data",),
            "cloud": tuple(ax for ax in ("pod", "data")
                           if ax in mesh.shape)}

    def wavg(params, group) -> None:
        layout = FlatLayout.of_single(params)
        flat = layout.ravel_single(params)
        mean = psum_weighted_mean(flat, torch.ones((), device=flat.device),
                                  group)
        with torch.no_grad():
            for p, m in zip(tree_leaves(params),
                            tree_leaves(layout.unravel_single(mean))):
                p.copy_(m)

    def step_fn(params, opt_state, batch, sync=None):
        if sync not in (None, "none", "edge", "cloud"):
            raise ValueError(f"sync must be None, 'none', 'edge' or "
                             f"'cloud', got {sync!r}")
        (loss, metrics), grads = value_and_grad(model.loss, params, batch)
        params, opt_state = optimizer.update(grads, opt_state, params)
        if sync in axes:
            wavg(params, getattr(mesh, "_".join(axes[sync]) + "_group"))
        metrics = dict(metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step_fn


def _to(tree, device):
    paths, leaves = tree_flatten(tree)
    return tree_unflatten(paths, [torch.as_tensor(v, device=device)
                                  for v in leaves])
