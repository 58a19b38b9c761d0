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
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.fl import clients
from repro_torch.fl.aggregate import psum_weighted_mean
from repro_torch.fl.flatten import FlatLayout


def stack_for_mesh(params: dict, num_edges: int, ues_per_edge: int) -> dict:
    """Replicate one parameter dict into the ``(E*U, ...)`` stacked
    layout (views of ``params``' leaves)."""
    n = num_edges * ues_per_edge
    return {k: (stack_for_mesh(v, num_edges, ues_per_edge)
                if isinstance(v, dict) else
                torch.as_tensor(v).unsqueeze(0).expand((n,) + tuple(v.shape)))
            for k, v in params.items()}


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
    """The HFL-scheduled train step of the transformer substrate: needs
    ``Model.loss`` and the optimizers, the training half that ROADMAP
    Queue 1 item 14 ports."""
    raise NotImplementedError(
        "make_local_sgd_train_step needs the transformer stack's training "
        "half (Model.loss, the optimizers), not ported to repro_torch yet "
        "(ROADMAP Queue 1 item 14)")


def _to(tree: dict, device) -> dict:
    return {k: (_to(v, device) if isinstance(v, dict) else
                torch.as_tensor(v, device=device))
            for k, v in tree.items()}
