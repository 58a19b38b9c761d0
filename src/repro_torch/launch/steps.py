"""Step assembly for the transformer stack: the train step, the greedy
serving step and the shardings of their arguments.  Ported from the JAX
package's ``repro/launch/steps.py``.

The ``*_shardings`` helpers return, in the reference's order, the
``NamedSharding`` tree of each argument (``.placements``: its DTensor
placements on ``model.mesh``) and its stand-ins (``meta`` tensors: shape
and dtype, no storage), from the model's logical axes
(``Model.axes``, ``input_axes``, ``decode_state_axes``) and the
optimizer's (``optim.opt_state_axes``).  ``sharding.empty_sharded`` makes
the arguments of those shapes as DTensors (under ``FakeTensorMode``: the
dry run's), ``sharding.distribute_tree`` shards real ones."""
from __future__ import annotations

import torch

from repro_torch.fl.flatten import tree_flatten, tree_unflatten
from repro_torch.optim.optimizers import Optimizer, opt_state_axes, tree_map
from repro_torch.parallel import sharding as shd


def value_and_grad(loss_fn, params, batch):
    """``((loss, metrics), grads)`` of ``loss_fn(params, batch)`` by
    autograd, the counterpart of ``jax.value_and_grad(has_aux=True)``:
    the gradients are a tree like ``params`` (zeros for a leaf the loss
    does not reach); loss and metrics come back detached.  ``params``'
    leaves are not touched: the loss sees detached aliases of them that
    require grad."""
    paths, leaves = tree_flatten(params)
    leaves = [leaf.detach().requires_grad_() for leaf in leaves]
    # on a mesh the backward, too, takes plain tensors as replicated
    with torch.enable_grad(), shd.on_mesh(shd.mesh_of(leaves[0])):
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
        with shd.on_mesh(getattr(model, "mesh", None)):
            return _train_step(params, opt_state, batch)

    def _train_step(params, opt_state, batch):
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
        # on a mesh the vocab dim gathered first: a DTensor's argmax over
        # a sharded dim reads offsets on the host
        next_tok = torch.argmax(shd.unshard(logits, -1), -1).to(torch.int32)
        return next_tok, state

    return serve_step


def train_shardings(model, optimizer: Optimizer, shape_cfg, rules=None):
    """(in_shardings, arg stand-ins) for train_step on model.mesh."""
    mesh = model.mesh
    rules = rules or model.rules
    p_shapes = model.param_shapes()
    p_axes = model.axes()
    p_sh = shd.logical_to_sharding(mesh, p_axes, p_shapes, rules)
    o_shapes = optimizer.init(p_shapes)
    o_axes = opt_state_axes(p_axes, o_shapes)
    o_sh = _opt_shardings(mesh, o_axes, o_shapes, rules)
    b_shapes = model.input_specs(shape_cfg)
    b_axes = model.input_axes(shape_cfg)
    b_sh = shd.logical_to_sharding(mesh, b_axes, b_shapes, rules)
    return (p_sh, o_sh, b_sh), (p_shapes, o_shapes, b_shapes)


def _opt_shardings(mesh, o_axes, o_shapes, rules):
    if o_axes == () or o_axes is None:
        return ()
    if isinstance(o_axes, dict) and "mu" in o_axes:
        return {
            "mu": shd.logical_to_sharding(mesh, o_axes["mu"], o_shapes["mu"],
                                          rules),
            "nu": shd.logical_to_sharding(mesh, o_axes["nu"], o_shapes["nu"],
                                          rules),
            "step": shd.NamedSharding(mesh, shd.P()),
        }
    return shd.logical_to_sharding(mesh, o_axes, o_shapes, rules)


def decode_shardings(model, shape_cfg, rules=None):
    """(in_shardings, arg stand-ins) for serve_step."""
    mesh = model.mesh
    rules = rules or model.rules
    p_shapes = model.param_shapes()
    p_sh = shd.logical_to_sharding(mesh, model.axes(), p_shapes, rules)
    s_shapes = model.decode_state_specs(shape_cfg)
    s_axes = model.decode_state_axes()
    s_sh = _state_shardings(mesh, s_axes, s_shapes, rules)
    t_shapes = model.input_specs(shape_cfg)["tokens"]
    t_sh = shd.logical_to_sharding(mesh, ("batch", None), t_shapes, rules)
    return (p_sh, s_sh, t_sh), (p_shapes, s_shapes, t_shapes)


def _state_shardings(mesh, s_axes, s_shapes, rules):
    """State axes trees have tuple leaves; align them with the shape tree
    (leaf by leaf, in the order of ``_flatten_axes``)."""
    flat_axes = iter(_flatten_axes(s_axes, s_shapes))

    def rec(s):
        if isinstance(s, dict):
            out = {k: rec(s[k]) for k in sorted(s)}
            return {k: out[k] for k in s}
        if isinstance(s, (list, tuple)):
            return [rec(v) for v in s]
        return shd.logical_to_sharding(mesh, next(flat_axes), s, rules)

    return rec(s_shapes)


def _flatten_axes(axes_tree, shape_tree):
    """Flatten axes tree in the same order as the shape tree leaves (dict
    keys sorted, as ``jax.tree.flatten`` orders them)."""
    out = []

    def rec(a, s):
        if isinstance(s, dict):
            for k in sorted(s):
                rec(a[k] if isinstance(a, dict) else a, s[k])
        elif isinstance(s, (list, tuple)):
            for i, sv in enumerate(s):
                av = a[i] if isinstance(a, (list, tuple)) and len(a) == len(s) else a
                rec(av, sv)
        else:
            out.append(a if (a is None or isinstance(a, tuple)) else None)

    rec(axes_tree, shape_tree)
    return out


def prefill_shardings(model, shape_cfg, rules=None):
    mesh = model.mesh
    rules = rules or model.rules
    p_shapes = model.param_shapes()
    p_sh = shd.logical_to_sharding(mesh, model.axes(), p_shapes, rules)
    b_shapes = model.input_specs(shape_cfg)
    b_sh = shd.logical_to_sharding(mesh, model.input_axes(shape_cfg),
                                   b_shapes, rules)
    return (p_sh, b_sh), (p_shapes, b_shapes)
