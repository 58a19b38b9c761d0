"""Step assembly for the transformer stack: the train step and the greedy
serving step.  Ported from the JAX package's ``repro/launch/steps.py``
(``make_train_step``, ``make_serve_step``); its ``*_shardings`` helpers
shard the transformer over a mesh, which the port does not yet (ROADMAP
Queue 1 item 13c)."""
from __future__ import annotations

import torch

from repro_torch.fl.flatten import tree_flatten, tree_unflatten
from repro_torch.optim.optimizers import Optimizer, tree_map


def value_and_grad(loss_fn, params, batch):
    """``((loss, metrics), grads)`` of ``loss_fn(params, batch)`` by
    autograd, the counterpart of ``jax.value_and_grad(has_aux=True)``:
    the gradients are a tree like ``params`` (zeros for a leaf the loss
    does not reach); loss and metrics come back detached.  ``params``'
    leaves are not touched: the loss sees detached aliases of them that
    require grad."""
    paths, leaves = tree_flatten(params)
    leaves = [leaf.detach().requires_grad_() for leaf in leaves]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(paths, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree_unflatten(paths, grads))


def make_train_step(model, optimizer: Optimizer, microbatches: int = 1):
    """The train step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``microbatches > 1`` splits the batch ``n`` ways along its
    first axis and runs them one after the other, accumulating the
    gradients in fp32 and dividing them, and the loss, by ``n`` (peak
    activation memory ~1/n).  The optimizer writes the new parameters and
    state into ``params`` and ``opt_state``."""

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            (loss, metrics), grads = value_and_grad(model.loss, params, batch)
        else:
            n = microbatches
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device), params)
            loss = None
            for i in range(n):
                mb = {k: _split(v, n, i) for k, v in batch.items()}
                (l, _m), g = value_and_grad(model.loss, params, mb)
                tree_map(lambda a, b: a.add_(b.to(torch.float32)), grads, g)
                loss = l if loss is None else loss + l
            tree_map(lambda g: g.div_(n), grads)
            loss = loss / n
            metrics = {}
        params, opt_state = optimizer.update(grads, opt_state, params)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def _split(x, n: int, i: int):
    """Microbatch ``i`` of ``n`` of a batch leaf (rows ``i*B/n`` on)."""
    x = torch.as_tensor(x)
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def make_serve_step(model):
    def serve_step(params, state, tokens):
        logits, state = model.decode_step(params, state, tokens)
        next_tok = torch.argmax(logits, -1).to(torch.int32)
        return next_tok, state

    return serve_step
