"""Local client solver (Alg. 1 lines 4-8), ported from the JAX package's
``repro/fl/clients.py``.

The paper uses full-batch GD locally ("we use GD in UE local training",
§III-B).  The JAX package writes the solver for one UE and ``jax.vmap``s
it; here one call steps all N UEs at once: ``torch.func.vmap`` of
``torch.func.grad`` over the stacked UE axis gives each UE the gradient of
its own loss, exactly.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad, vmap

from repro_torch.fl.flatten import tree_leaves


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
