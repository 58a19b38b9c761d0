"""The plain versions of the port's aggregation kernels (eq. 6 edge,
eq. 10 cloud) against the JAX package's Pallas kernels (interpret mode on
the CPU, through ``repro.kernels.ops``) and its ``ref.py`` oracles, within
1e-5: the sums run in other orders.  The CUDA kernels themselves are held
to their plain versions in ``test_torch_kernels.py``, on a card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.fl import aggregate as j_agg  # noqa: E402
from repro.kernels import ops, ref  # noqa: E402
from repro_torch.fl import aggregate as t_agg  # noqa: E402
from repro_torch.kernels import hier_aggregate as ha  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)

# name -> (N, F, M, dtype, edit of the inputs)
CASES = {
    "narrow": (12, 37, 3, "float32", None),
    "zero_member_edge": (10, 16, 4, "float32", "empty_group"),
    "zero_weight_edge": (10, 16, 3, "float32", "zero_weight_group"),
    "bf16": (16, 40, 3, "bfloat16", None),
    "past_tpu_split_n600": (600, 9, 5, "float32", None),
}


def _inputs(name):
    n, f, m, dtype, edit = CASES[name]
    rng = np.random.default_rng(len(name))
    x = rng.normal(0, 1, (n, f)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    g = rng.integers(0, m, n).astype(np.int32)
    g[:m] = np.arange(m)                     # every group has a member
    if edit == "empty_group":
        g[g == 2] = 0
    if edit == "zero_weight_group":
        w[g == 1] = 0.0
    jx = jnp.asarray(x, dtype=jnp.bfloat16 if dtype == "bfloat16" else None)
    tx = torch.from_numpy(x)
    if dtype == "bfloat16":
        tx = tx.to(torch.bfloat16)
    return (jx, jnp.asarray(w), jnp.asarray(g), m,
            tx, torch.from_numpy(w), torch.from_numpy(g), edit)


@pytest.mark.parametrize("name", sorted(CASES))
def test_segment_aggregate_plain_matches_pallas_and_ref(name):
    jx, jw, jg, m, tx, tw, tg, edit = _inputs(name)
    out = ha.segment_aggregate_plain(tx, tw, tg, m)
    assert out.dtype == torch.float32 and out.shape == tx.shape
    np.testing.assert_allclose(
        out.numpy(), np.asarray(ops.hier_segment_aggregate(
            jx, jw, jg, num_groups=m)), **TOL)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(ref.hier_segment_aggregate_ref(
            jx, jw, jg, m)), **TOL)
    if edit == "zero_weight_group":
        rows = tg.numpy() == 1
        assert (out.numpy()[rows] == 0.0).all()     # exactly 0, not NaN
    assert np.isfinite(out.numpy()).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_cloud_aggregate_plain_matches_pallas_and_ref(name):
    jx, jw, _, _, tx, tw, _, _ = _inputs(name)
    out = ha.cloud_aggregate_plain(tx, tw)
    assert out.dtype == torch.float32 and out.shape == tx.shape
    np.testing.assert_allclose(
        out.numpy(), np.asarray(ops.hier_cloud_aggregate(jx, jw)), **TOL)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(ref.hier_bcast_aggregate_ref(jx, jw)), **TOL)


@pytest.mark.parametrize("n", [40, 600])
def test_cloud_aggregate_all_zero_weights_give_nan_as_the_reference(n):
    """No 1e-12 guard in eq. 10: all-zero weights give NaN in the plain
    version (the CPU route and the kernel's oracle), as in
    ``ref.hier_bcast_aggregate_ref`` and the JAX package's plain route
    ``flat_cloud_aggregate(use_kernel=False)``, on both sides of the TPU
    kernel's N = 512 split."""
    x = np.random.default_rng(n).normal(0, 1, (n, 7)).astype(np.float32)
    w = np.zeros(n, np.float32)
    out = ha.cloud_aggregate_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert out.shape == (n, 7) and out.isnan().all()
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    assert np.isnan(np.asarray(ref.hier_bcast_aggregate_ref(jx, jw))).all()
    assert np.isnan(np.asarray(
        j_agg.flat_cloud_aggregate(jx, jw, use_kernel=False))).all()
    assert ha.cloud_aggregate(torch.from_numpy(x),
                              torch.from_numpy(w)).isnan().all()


def test_cpu_wrappers_take_plain_versions_without_launching():
    _, _, _, m, tx, tw, tg, _ = _inputs("narrow")
    before = dict(ha.launch_counts)
    assert torch.equal(ha.segment_aggregate(tx, tw, tg, m),
                       ha.segment_aggregate_plain(tx, tw, tg, m))
    assert torch.equal(ha.cloud_aggregate(tx, tw),
                       ha.cloud_aggregate_plain(tx, tw))
    assert ha.launch_counts == before


@pytest.mark.parametrize("bad", ["x_3d", "x_f64", "w_f64", "w_len",
                                 "g_int64", "x_strided", "too_many_groups"])
def test_wrappers_reject_inputs_the_kernels_do_not_take(bad):
    x = torch.zeros(6, 8)
    w = torch.ones(6)
    g = torch.zeros(6, dtype=torch.int32)
    m = 2
    if bad == "x_3d":
        x = x[None]
    elif bad == "x_f64":
        x = x.double()
    elif bad == "w_f64":
        w = w.double()
    elif bad == "w_len":
        w = w[:5]
    elif bad == "g_int64":
        g = g.long()
    elif bad == "x_strided":
        x = torch.zeros(6, 16)[:, ::2]
    elif bad == "too_many_groups":
        m = ha.MAX_GROUPS + 1
    with pytest.raises((ValueError, TypeError)):
        ha.segment_aggregate(x, w, g, m)
    if bad not in ("g_int64", "too_many_groups"):
        with pytest.raises((ValueError, TypeError)):
            ha.cloud_aggregate(x, w)


def _jax_tree(tree):
    return {k: (_jax_tree(v) if isinstance(v, dict) else jnp.asarray(v))
            for k, v in tree.items()}


def test_flat_and_stacked_aggregation_match_reference():
    jx, jw, jg, m, tx, tw, tg, _ = _inputs("narrow")
    np.testing.assert_allclose(
        t_agg.flat_edge_aggregate(tx, tw, tg, m).numpy(),
        np.asarray(j_agg.flat_edge_aggregate(jx, jw, jg, m,
                                             use_kernel=False)), **TOL)
    np.testing.assert_allclose(
        t_agg.flat_cloud_aggregate(tx, tw).numpy(),
        np.asarray(j_agg.flat_cloud_aggregate(jx, jw, use_kernel=False)),
        **TOL)
    rng = np.random.default_rng(3)
    stacked = {"a": {"w": rng.normal(0, 1, (12, 3, 2)).astype(np.float32)},
               "b": rng.normal(0, 1, (12, 5)).astype(np.float32)}
    tstack = {"a": {"w": torch.from_numpy(stacked["a"]["w"])},
              "b": torch.from_numpy(stacked["b"])}
    for kw in ({}, {"group_ids": tg, "num_groups": m}):
        jkw = {k: (jnp.asarray(v.numpy()) if torch.is_tensor(v) else v)
               for k, v in kw.items()}
        jo = j_agg.stacked_weighted_average(
            _jax_tree(stacked), jw, use_kernel=False, **jkw)
        to = t_agg.stacked_weighted_average(tstack, tw, **kw)
        np.testing.assert_allclose(to["a"]["w"].numpy(),
                                   np.asarray(jo["a"]["w"]), **TOL)
        np.testing.assert_allclose(to["b"].numpy(), np.asarray(jo["b"]),
                                   **TOL)
