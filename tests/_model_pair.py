"""Shared helpers of the model parity tests: one model run through the JAX
package and the port on the same numpy inputs, and the comparisons.

A run is the training loss on a batch, the prefill on the batch's prompt
part, and decode steps teacher-forced with given tokens: the logits of
each step and the decode state after the prefill and after the last step.
The reference runs jitted, each method compiled once a model; trees are
compared leaf by leaf, after flattening dicts (sorted keys) and lists.
"""
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.launch import serve as j_serve
from repro.models.model import Model as JModel
from repro_torch.models.model import Model
from repro_torch.weights import from_jax_params

JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def dtype_name(x) -> str:
    """'float32', 'bfloat16', 'int32' ... of a tensor or an array."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).rsplit(".", 1)[-1]
    return np.asarray(x).dtype.name


def as_np(x) -> np.ndarray:
    """A tensor or JAX array as numpy; bfloat16 widened to float32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def flat(tree, path=()):
    """[(path, leaf)] of a tree of dicts (sorted keys) and lists."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flat(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in flat(v, path + (i,))]
    return [(path, tree)]


def rel_err(a, b) -> float:
    """max|a - b| over the largest |b| (the reference's scale)."""
    a, b = as_np(a).astype(np.float64), as_np(b).astype(np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def assert_trees_close(t_tree, j_tree, tol, what):
    """Same paths, shapes and dtypes leaf for leaf; float leaves within
    ``tol`` of each reference leaf's scale, integer leaves equal."""
    t, j = flat(t_tree), flat(j_tree)
    assert [p for p, _ in t] == [p for p, _ in j], what
    for (path, a), (_, b) in zip(t, j):
        assert dtype_name(a) == dtype_name(b), (what, path)
        assert tuple(a.shape) == tuple(np.shape(b)), (what, path)
        if np.issubdtype(as_np(b).dtype, np.integer):
            np.testing.assert_array_equal(as_np(a), as_np(b),
                                          err_msg=f"{what} {path}")
        else:
            err = rel_err(a, b)
            assert err <= tol, f"{what} {path}: {err:.3e} > {tol:g}"


def carried(cfg, param_dtype=jnp.float32, seed=0):
    """The reference's parameters (``param_dtype``) from ``seed`` and the
    same parameters carried over to the port on the CPU."""
    jp = JModel(cfg, param_dtype=param_dtype).init(jax.random.PRNGKey(seed))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def prompt_part(batch: dict) -> dict:
    return {k: v for k, v in batch.items() if k != "targets"}


def reference_run(cfg, impl, params, batch, feed, *, param_dtype=jnp.float32,
                  act_dtype=jnp.float32) -> dict:
    """The reference's loss, prefill and len(feed) teacher-forced decode
    steps (``feed``: a list of (B, 1) int32 arrays)."""
    model = JModel(cfg, impl=impl, param_dtype=param_dtype,
                   act_dtype=act_dtype)
    jb = jax.tree.map(jnp.asarray, batch)
    loss = jax.jit(model.loss)(params, jb)[0]
    logits, state = jax.jit(model.prefill)(params, prompt_part(jb))
    run = {"loss": loss, "prefill": logits, "state0": state, "decode": []}
    step = jax.jit(model.decode_step)
    for tok in feed:
        lg, state = step(params, state, jnp.asarray(tok))
        run["decode"].append(lg)
    run["state"] = state
    jax.effects_barrier()
    return run


def port_run(cfg, impl, params, batch, feed, *, param_dtype=torch.float32,
             act_dtype=torch.float32) -> dict:
    """The port's counterpart of ``reference_run`` on the CPU."""
    model = Model(cfg, impl=impl, param_dtype=param_dtype,
                  act_dtype=act_dtype, device="cpu")
    with torch.no_grad():
        loss = model.loss(params, batch)[0]
        logits, state = model.prefill(params, prompt_part(batch))
        run = {"loss": loss, "prefill": logits, "state0": state,
               "decode": []}
        for tok in feed:
            lg, state = model.decode_step(params, state, tok)
            run["decode"].append(lg)
    run["state"] = state
    return run


def assert_runs_close(t_run, j_run, tol, what=""):
    """Loss within ``tol`` relative; prefill and decode logits and both
    decode states within ``tol`` of each reference leaf's scale; every
    dtype equal."""
    assert_trees_close(t_run["loss"], j_run["loss"], tol, f"{what} loss")
    assert_trees_close(t_run["prefill"], j_run["prefill"], tol,
                       f"{what} prefill logits")
    assert_trees_close(t_run["state0"], j_run["state0"], tol,
                       f"{what} prefill state")
    assert len(t_run["decode"]) == len(j_run["decode"])
    for i, (a, b) in enumerate(zip(t_run["decode"], j_run["decode"])):
        assert_trees_close(a, b, tol, f"{what} decode step {i} logits")
    assert_trees_close(t_run["state"], j_run["state"], tol,
                       f"{what} final state")


class _Stop(Exception):
    pass


def reference_cli_batch(monkeypatch, argv) -> dict:
    """The batch the reference's serving CLI prefills (its ``main`` run
    with ``argv`` and stopped at its first jitted call), as numpy."""
    seen = {}

    def fake_jit(fn, **_kw):
        def call(_params, batch):
            seen.update(jax.tree.map(np.asarray, batch))
            raise _Stop
        return call
    monkeypatch.setattr(j_serve.jax, "jit", fake_jit)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(_Stop):
        j_serve.main()
    monkeypatch.undo()
    return seen


def assert_batches_equal(t_batch, j_batch):
    """The same keys, dtypes, shapes and values, exactly."""
    assert sorted(t_batch) == sorted(j_batch)
    for k in j_batch:
        a, b = as_np(t_batch[k]), np.asarray(j_batch[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
