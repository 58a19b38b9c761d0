"""The port's flat-buffer layout against the JAX package's: the same
stacked parameters give the same ``(N, F_total)`` buffer column for column
(the leaf order is ``jax.tree.flatten``'s sorted dict keys), and the
round trips are exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.lenet_mnist import LeNetConfig as JLeNetConfig  # noqa: E402
from repro.fl.flatten import FlatLayout as JFlatLayout  # noqa: E402
from repro.models import lenet as j_lenet  # noqa: E402
from repro_torch.fl.flatten import FlatLayout, tree_leaves  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402


def _stacked_lenet(n=3, seed=0):
    shapes = jax.eval_shape(lambda k: j_lenet.lenet_init(k, JLeNetConfig()),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.normal(0, 1, (n,) + s.shape).astype(np.float32),
        shapes)


def test_buffer_matches_reference_column_for_column():
    stacked = _stacked_lenet()
    jl = JFlatLayout.of(jax.tree.map(jnp.asarray, stacked))
    jbuf = np.asarray(jl.ravel(jax.tree.map(jnp.asarray, stacked)))
    tp = from_jax_params(stacked, device="cpu")
    tl = FlatLayout.of(tp)
    tbuf = tl.ravel(tp)
    assert (tl.offsets, tl.sizes, tl.total) == (jl.offsets, jl.sizes,
                                                jl.total)
    assert tl.shapes == jl.shapes
    assert tbuf.dtype == torch.float32 and tbuf.is_contiguous()
    np.testing.assert_array_equal(tbuf.numpy(), jbuf)
    single = jax.tree.map(lambda x: x[1], stacked)
    np.testing.assert_array_equal(
        FlatLayout.of_single(from_jax_params(single, device="cpu"))
        .ravel_single(from_jax_params(single, device="cpu")).numpy(),
        np.asarray(JFlatLayout.of_single(single).ravel_single(single)))


def test_round_trips_are_exact_and_leaves_view_the_buffer():
    tp = from_jax_params(_stacked_lenet(n=4, seed=1), device="cpu")
    layout = FlatLayout.of(tp)
    buf = layout.ravel(tp)
    back = layout.unravel(buf)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, back)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, tp))
    for a, b in zip(tree_leaves(tp), tree_leaves(back)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)
    # the leaves are views: an in-place update lands in the buffer
    back["fc2"]["w"].add_(1.0)
    assert torch.equal(layout.unravel(buf)["fc2"]["w"], tp["fc2"]["w"] + 1)
    single = {k: {kk: v[2] for kk, v in d.items()} for k, d in tp.items()}
    sl = FlatLayout.of_single(single)
    for a, b in zip(tree_leaves(single),
                    tree_leaves(sl.unravel_single(sl.ravel_single(single)))):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        layout.ravel({"fc1": tp["fc1"]})
