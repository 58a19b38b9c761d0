"""The port's LeNet and logistic regression against the JAX package's, on
the same carried-over parameters and batch: loss, accuracy and every
gradient leaf within 1e-5 absolute (fp32; the two sum in other orders)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.lenet_mnist import SMOKE_CONFIG as J_SMOKE  # noqa: E402
from repro.configs.lenet_mnist import LeNetConfig as JLeNetConfig  # noqa: E402
from repro.models import lenet as j_lenet  # noqa: E402
from repro_torch.configs.lenet_mnist import (SMOKE_CONFIG,  # noqa: E402
                                             LeNetConfig)
from repro_torch.fl.flatten import tree_leaves  # noqa: E402
from repro_torch.models import lenet as t_lenet  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

ATOL = 1e-5


def _numpy_lenet_params(cfg, rng):
    """Random parameters in the JAX package's LeNet layout (drawn with
    numpy: eager ``jax.random`` on the CPU takes seconds)."""
    shapes = jax.eval_shape(lambda k: j_lenet.lenet_init(k, cfg),
                            jax.random.PRNGKey(0))
    return jax.tree.map(
        lambda s: rng.normal(0, 0.2, s.shape).astype(np.float32), shapes)


def _case(name):
    rng = np.random.default_rng(0)
    if name == "logreg":
        params = {"w": rng.normal(0, 0.3, (12, 4)).astype(np.float32),
                  "b": rng.normal(0, 0.3, (4,)).astype(np.float32)}
        batch = {"images": rng.normal(0, 1, (4, 12)).astype(np.float32),
                 "labels": rng.integers(0, 4, 4).astype(np.int32)}
        return (params, batch, lambda p, b: j_lenet.logreg_loss(p, b, 1e-3),
                lambda p, b: t_lenet.logreg_loss(p, b, 1e-3))
    cfg = {"lenet_smoke": J_SMOKE, "lenet_full": JLeNetConfig()}[name]
    params = _numpy_lenet_params(cfg, rng)
    batch = {"images": rng.normal(0, 1, (4, 28, 28, 1)).astype(np.float32),
             "labels": rng.integers(0, 10, 4).astype(np.int32)}
    return params, batch, j_lenet.lenet_loss, t_lenet.lenet_loss


@pytest.mark.parametrize("name", ["logreg", "lenet_smoke", "lenet_full"])
def test_loss_metrics_and_grads_match_reference(name):
    params, batch, j_loss, t_loss = _case(name)
    (jl, jm), jg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, batch))
    tp = from_jax_params(params, device="cpu")
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    tg, (tl, tm) = torch.func.grad_and_value(t_loss, has_aux=True)(tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), atol=ATOL, rtol=0)
    assert float(tm["acc"]) == float(jm["acc"])
    jleaves = jax.tree.leaves(jg)
    tleaves = tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("cfg,jcfg,count", [
    (LeNetConfig(), JLeNetConfig(), 44_426), (SMOKE_CONFIG, J_SMOKE, None)])
def test_init_layout_matches_reference(cfg, jcfg, count):
    jp = jax.eval_shape(lambda k: j_lenet.lenet_init(k, jcfg),
                        jax.random.PRNGKey(0))
    tp = t_lenet.lenet_init(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    assert jax.tree.structure(jp) == jax.tree.structure(
        jax.tree.map(lambda t: 0, tp))
    for j, t in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
    n = sum(t.numel() for t in tree_leaves(tp))
    assert n == sum(int(np.prod(j.shape)) for j in jax.tree.leaves(jp))
    if count is not None:
        assert n == count
    again = t_lenet.lenet_init(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    for a, b in zip(tree_leaves(tp), tree_leaves(again)):
        assert torch.equal(a, b)
