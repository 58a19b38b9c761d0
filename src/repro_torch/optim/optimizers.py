"""Minimal optimizer library, ported from the JAX package's
``repro/optim/optimizers.py`` (optax-style ``init``/``update`` pairs).

States are trees matching the parameter tree (nested dicts and lists of
tensors), so a state leaf sits beside its parameter leaf.  The arithmetic
and defaults are the reference's: AdamW's ``b2`` is 0.95, its bias
corrections are float32 powers of an int32 step, its update is
``mhat / (sqrt(vhat) + eps)`` and the decay ``weight_decay * p`` is added
to the update before it is scaled by ``lr``.

``update(grads, state, params)`` writes the new parameters and state INTO
``params`` and ``state`` (under ``torch.no_grad()``): at full width a
functional copy of StableLM-1.6B's parameters, moments and gradients would
cost 6.6 GB a tree.  It still returns ``(params, state)``, so callers read
as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]  # (grads, state, params) -> (params, state)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts and lists (and the matching
    leaves of ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    @torch.no_grad()
    def update(grads, state, params):
        if momentum == 0.0:
            tree_map(lambda p, g: p.sub_(lr * g.to(p.dtype)), params, grads)
            return params, ()
        tree_map(lambda v, g: v.mul_(momentum).add_(g.to(v.dtype)), state,
                 grads)
        tree_map(lambda p, v: p.sub_(lr * v.to(p.dtype)), params, state)
        return params, state

    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        # zeros_like keeps a DTensor parameter's placements
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        leaf = _first_leaf(params)
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=leaf.device if leaf is not None
                                    else None)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"].add_(1)
        t = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                           device=t.device), t)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                           device=t.device), t)

        def moments(m, v, g):
            g = g.to(torch.float32)
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g.square().mul_(1 - b2))

        def upd(p, m, v):
            delta = m / bc1
            delta.div_((v / bc2).sqrt_().add_(eps))
            if weight_decay:
                delta.add_(weight_decay * p.to(torch.float32))
            if p.dtype == torch.float32:
                p.sub_(delta.mul_(lr))
            else:
                p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))

        tree_map(moments, state["mu"], state["nu"], grads)
        tree_map(upd, params, state["mu"], state["nu"])
        return params, state

    return Optimizer(init, update)


def opt_state_axes(params_axes, state):
    """Logical axes for an optimizer state tree (mirrors param axes)."""
    if state == () or state is None:
        return ()
    if isinstance(state, dict) and "mu" in state:
        return {"mu": params_axes, "nu": params_axes, "step": None}
    return params_axes


def _first_leaf(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            leaf = _first_leaf(v)
            if leaf is not None:
                return leaf
        return None
    return tree
