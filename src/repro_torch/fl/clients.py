"""Local client solvers (Alg. 1 lines 4-8), ported from the JAX package's
``repro/fl/clients.py``.

The paper uses full-batch GD locally ("we use GD in UE local training",
§III-B) and cites DANE [22] as the training algorithm.  The JAX package
writes each solver for one UE and ``jax.vmap``s it; here one call steps
all N UEs at once: ``torch.func.vmap`` of ``torch.func.grad`` over the
stacked UE axis gives each UE the gradient of its own loss, exactly.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad, vmap

from repro_torch.fl.aggregate import psum_weighted_mean
from repro_torch.fl.flatten import FlatLayout, tree_leaves


def gd_local_steps(loss_fn: Callable, a: int, lr: float):
    """a iterations of full-batch gradient descent on every UE's own data.

    ``loss_fn(params, batch) -> (loss, metrics)`` is one UE's loss.  The
    returned ``run(params, batches)`` takes STACKED params and batches
    (leading UE axis) and updates the param leaves IN PLACE (when they are
    views of the simulator's flat buffer, that is where the step lands)."""
    per_ue_grad = vmap(grad(lambda p, b: loss_fn(p, b)[0]))

    def run(params: dict, batches: dict) -> dict:
        leaves = tree_leaves(params)
        with torch.no_grad():
            for _ in range(a):
                grads = tree_leaves(per_ue_grad(params, batches))
                for p, g in zip(leaves, grads):
                    p.sub_(lr * g)
        return params

    return run


def dane_local_steps(loss_fn: Callable, a: int, lr: float,
                     mu_prox: float = 0.1, eta_grad: float = 1.0):
    """DANE [22] local update.  Each UE takes ``a`` GD steps on

        F_n(w) - <grad F_n(w0) - eta * g_bar, w> + (mu/2) ||w - w0||^2

    where ``w0`` is its params at the call and ``g_bar`` the aggregated
    global gradient at w0 (Alg. 1 line 5 broadcasts it).  The returned
    ``run(params, batches, g_bar)`` takes STACKED params and batches and
    an UNSTACKED ``g_bar`` and, like ``gd_local_steps``, updates the param
    leaves IN PLACE.  The objective's gradient is written out:
    ``grad F_n(w) - (grad F_n(w0) - eta g_bar) + mu (w - w0)``."""
    per_ue_grad = vmap(grad(lambda p, b: loss_fn(p, b)[0]))

    def run(params: dict, batches: dict, g_bar: dict) -> dict:
        leaves = tree_leaves(params)
        with torch.no_grad():
            w0 = [p.clone() for p in leaves]
            lin = [g0 - eta_grad * gb for g0, gb in
                   zip(tree_leaves(per_ue_grad(params, batches)),
                       tree_leaves(g_bar))]
            for _ in range(a):
                grads = tree_leaves(per_ue_grad(params, batches))
                for p, g, c, p0 in zip(leaves, grads, lin, w0):
                    p.sub_(lr * (g - c + mu_prox * (p - p0)))
        return params

    return run


def global_gradient(loss_fn: Callable, stacked_params: dict,
                    stacked_batch: dict, weights: torch.Tensor,
                    group=None) -> dict:
    """Alg. 1 line 5: the weighted mean of the per-UE gradients, one
    UNSTACKED dict.

    With ``group`` (a mesh's data group) the rows are this rank's data
    shard: its weighted gradient sum and weight sum meet the other shards'
    in one all-reduce, and every rank gets the global mean."""
    grads = vmap(grad(lambda p, b: loss_fn(p, b)[0]))(stacked_params,
                                                      stacked_batch)
    if group is None:
        w = weights / weights.sum()
        return _map(lambda g: torch.tensordot(w, g.to(torch.float32),
                                              dims=1), grads)
    layout = FlatLayout.of(grads)
    num = weights @ layout.ravel(grads)
    return layout.unravel_single(psum_weighted_mean(num, weights.sum(),
                                                    group))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)
