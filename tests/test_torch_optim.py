"""The port's optimizers (``repro_torch.optim``) against the JAX package's
(``repro.optim``): ``sgd`` with momentum 0 and 0.9 and ``adamw`` with
weight decay 0 and 0.1 over 5 steps on a tree of nested dicts and a list
(the transformer stack's ``"layers"`` layout), the same numpy params and
gradients in both; params and state within rtol 1e-6 after every step,
AdamW's int32 step equal.  The port writes params and state in place; the
test also holds the returned trees to be those same objects, and the
defaults (``b2`` 0.95, not ``torch.optim``'s 0.999) and ``opt_state_axes``
to the reference's."""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as j_optim  # noqa: E402
from repro.optim import optimizers as j_opts  # noqa: E402
from repro_torch import optim as t_optim  # noqa: E402
from repro_torch.fl.flatten import tree_leaves  # noqa: E402
from repro_torch.optim import optimizers as t_opts  # noqa: E402

STEPS = 5
RTOL = 1e-6
SHAPES = {"embedding": (7, 5), "final_norm": {"scale": (5,)},
          "layers": [{"w": (5, 3), "b": (3,)}, {"w": (3, 5)}]}
# name -> (factory, kwargs)
CASES = {"sgd": ("sgd", dict(lr=0.1)),
         "sgd_momentum": ("sgd", dict(lr=0.1, momentum=0.9)),
         "adamw": ("adamw", dict(lr=3e-3)),
         "adamw_decay": ("adamw", dict(lr=3e-3, weight_decay=0.1))}


def _tree(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree(rng, v, scale) for v in shapes]
    return (scale * rng.normal(size=shapes)).astype(np.float32)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch(v) for v in tree]
    return torch.tensor(tree)


def _close(t_tree, j_tree, what):
    tl, jl = tree_leaves(t_tree), jax.tree.leaves(j_tree)
    assert len(tl) == len(jl), what
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=RTOL * float(np.abs(b).max()),
                                   err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_optimizer_matches_reference(name):
    factory, kw = CASES[name]
    rng = np.random.default_rng(len(name))
    init = _tree(rng, SHAPES)
    grads = [_tree(rng, SHAPES, scale=10.0 ** -i) for i in range(STEPS)]
    j_opt = getattr(j_optim, factory)(**kw)
    t_opt = getattr(t_optim, factory)(**kw)
    jp = jax.tree.map(jnp.asarray, init)
    js = j_opt.init(jp)
    tp = _torch(init)
    ts = t_opt.init(tp)
    for i, g in enumerate(grads):
        jp, js = j_opt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp2, ts2 = t_opt.update(_torch(g), ts, tp)
        assert tp2 is tp and ts2 is ts          # written in place
        _close(tp, jp, f"{name} params, step {i + 1}")
        if factory == "adamw":
            _close(ts["mu"], js["mu"], f"{name} mu, step {i + 1}")
            _close(ts["nu"], js["nu"], f"{name} nu, step {i + 1}")
            assert ts["step"].dtype == torch.int32
            assert int(ts["step"]) == int(js["step"]) == i + 1
        elif kw.get("momentum"):
            _close(ts, js, f"{name} velocity, step {i + 1}")
        else:
            assert ts == () and js == ()


def test_defaults_and_state_axes_match_reference():
    for fn in ("sgd", "adamw"):
        t_sig = inspect.signature(getattr(t_opts, fn)).parameters
        j_sig = inspect.signature(getattr(j_opts, fn)).parameters
        assert {k: v.default for k, v in t_sig.items()} == \
            {k: v.default for k, v in j_sig.items()}
    assert inspect.signature(t_opts.adamw).parameters["b2"].default == 0.95
    axes = {"w": ("embed", "mlp")}
    p = {"w": torch.zeros(2, 3)}
    jp = {"w": jnp.zeros((2, 3))}
    for opt in ("sgd", "adamw"):
        for kw in ({}, {"momentum": 0.9}) if opt == "sgd" else ({},):
            t_state = getattr(t_optim, opt)(0.1, **kw).init(p)
            j_state = getattr(j_optim, opt)(0.1, **kw).init(jp)
            assert t_opts.opt_state_axes(axes, t_state) == \
                j_opts.opt_state_axes(axes, j_state)


def test_adamw_keeps_a_bf16_leaf_bf16():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    opt = t_optim.adamw(0.1)
    st = opt.init(p)
    assert st["mu"]["w"].dtype == torch.float32
    opt.update({"w": torch.full((4,), 2.0, dtype=torch.bfloat16)}, st, p)
    assert p["w"].dtype == torch.bfloat16
    assert float(p["w"][0]) == pytest.approx(0.9, abs=4e-3)
