"""The port's streaming edge aggregation, async merge and survivor weights
against the JAX package's, on the same numpy inputs.

* ``segment_sum_plain`` (the plain version of the ``segment_sum`` CUDA
  kernel) against the Pallas kernel ``hier_segment_accumulate`` (interpret
  mode on the CPU) and against ``jax.ops.segment_sum``: 1e-5, the sums run
  in other orders.
* ``flat_staleness_merge``, ``survivor_weights``, the
  ``StreamingEdgeAccumulator`` and ``streaming_edge_aggregate`` against
  ``repro.fl.aggregate``: 1e-5, with exact zeros where the reference has
  them.  The CUDA kernel itself is held to its plain version in
  ``test_torch_kernels.py``, on a card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.fl import aggregate as j_agg  # noqa: E402
from repro.kernels import ops  # noqa: E402
from repro_torch.fl import aggregate as t_agg  # noqa: E402
from repro_torch.kernels import hier_aggregate as ha  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)

# name -> (N, F, M, dtype, edit of the inputs)
SUM_CASES = {
    "narrow": (12, 37, 3, "float32", None),
    "memberless_group": (10, 16, 4, "float32", "empty_group"),
    "zero_weight_group": (10, 16, 3, "float32", "zero_weight_group"),
    "bf16": (16, 40, 3, "bfloat16", None),
    "one_row": (1, 33, 2, "float32", None),
    "past_tpu_split_n600": (600, 9, 5, "float32", None),
}


def _sum_inputs(name):
    n, f, m, dtype, edit = SUM_CASES[name]
    rng = np.random.default_rng(len(name))
    x = rng.normal(0, 1, (n, f)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    g = rng.integers(0, m, n).astype(np.int32)
    if edit == "empty_group":
        g[g == 2] = 0
    if edit == "zero_weight_group":
        w[g == 1] = 0.0
    jx = jnp.asarray(x, dtype=jnp.bfloat16 if dtype == "bfloat16" else None)
    tx = torch.from_numpy(x)
    if dtype == "bfloat16":
        tx = tx.to(torch.bfloat16)
    return jx, tx, w, g, m, edit


@pytest.mark.parametrize("name", sorted(SUM_CASES))
def test_segment_sum_plain_matches_pallas_and_segment_sum(name):
    jx, tx, w, g, m, edit = _sum_inputs(name)
    out = ha.segment_sum_plain(tx, torch.from_numpy(w), torch.from_numpy(g),
                               m)
    assert out.dtype == torch.float32 and tuple(out.shape) == (m, tx.shape[1])
    pallas = ops.hier_segment_accumulate(jx, jnp.asarray(w), jnp.asarray(g),
                                         num_groups=m)
    seg = jax.ops.segment_sum(jnp.asarray(w)[:, None] *
                              jx.astype(jnp.float32), jnp.asarray(g),
                              num_segments=m)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(seg), **TOL)
    if edit == "empty_group":
        assert (out[2] == 0).all()
    if edit == "zero_weight_group":
        assert (out[1] == 0).all()


def test_segment_sum_wrapper_adds_into_out_on_cpu():
    _, tx, w, g, m, _ = _sum_inputs("narrow")
    tw, tg = torch.from_numpy(w), torch.from_numpy(g)
    plain = ha.segment_sum_plain(tx, tw, tg, m)
    assert torch.equal(ha.segment_sum(tx, tw, tg, m), plain)
    acc = torch.ones(m, tx.shape[1])
    before = dict(ha.launch_counts)
    out = ha.segment_sum(tx, tw, tg, m, out=acc)
    assert out is acc
    assert torch.equal(acc, 1.0 + plain)
    assert ha.launch_counts == before     # the plain version is no launch


@pytest.mark.parametrize("bad", ["groups", "out_shape", "out_dtype"])
def test_segment_sum_wrapper_rejects_what_the_kernel_does_not_take(bad):
    _, tx, w, g, m, _ = _sum_inputs("narrow")
    tw, tg = torch.from_numpy(w), torch.from_numpy(g)
    kw = {"groups": dict(num_groups=ha.MAX_GROUPS + 1),
          "out_shape": dict(out=torch.zeros(m + 1, tx.shape[1])),
          "out_dtype": dict(out=torch.zeros(m, tx.shape[1],
                                            dtype=torch.float64))}[bad]
    with pytest.raises(ValueError):
        ha.segment_sum(tx, tw, tg, kw.pop("num_groups", m), **kw)


@pytest.mark.parametrize("n,f,m,slices,rows,warps", [
    (8192, 1024, 16, 16, 512, 16),   # streaming chunk: 8 column tiles only
    (100, 44_426, 5, 1, 100, 8),     # LeNet cohort: 348 tiles fill the card
    (7, 1024, 16, 1, 7, 1), (1, 1024, 16, 1, 1, 1),
    (8000, 1001, 16, 16, 500, 16), (1000, 300, 5, 15, 67, 16),
    (2000, 300, ha.MAX_GROUPS, 31, 65, 1)])   # one warp's slots fill a block
def test_segment_sum_slice_rule(n, f, m, slices, rows, warps):
    assert ha.segment_sum_plan(n, f, m) == (slices, rows, warps)
    assert (slices - 1) * rows < n <= slices * rows
    tiles = -(-f // ha.TILE)
    assert tiles * slices <= max(tiles, ha.NUM_SMS)   # one block an SM
    assert slices == 1 or rows >= ha.MIN_SLICE_ROWS
    assert warps * m * ha.TILE * 4 <= ha.SMEM_BYTES   # the warps' slots
    assert warps == 1 or warps * tiles * slices <= \
        ha.RESIDENT_WARPS * ha.NUM_SMS                # one wave


@pytest.mark.parametrize("n,f,m,warps", [
    (100, 44_426, 5, 8),             # phases 3 and 5: a LeNet cohort
    (60, 44_426, 5, 8),              # phase 9: a shard's slab
    (1000, 1000, 5, 16), (100, 1000, 5, 16), (12, 37, 3, 2),
    (16, 1024, 5, 2), (17, 1024, 5, 4),
    (100, 300, 200, 2),              # two warps' slots fill a block
    (500, 300, ha.MAX_GROUPS, 1)])
def test_segment_aggregate_warps_rule(n, f, m, warps):
    assert ha.segment_aggregate_warps(n, f, m) == warps
    tiles = -(-f // ha.TILE)
    slot_bytes = m * (ha.TILE + 1) * 4
    assert warps * slot_bytes <= ha.SMEM_BYTES
    assert warps == 1 or warps * tiles <= ha.RESIDENT_WARPS * ha.NUM_SMS
    assert (warps == ha.MAX_WARPS or warps * ha.WARP_ROWS >= n
            or 2 * warps * slot_bytes > ha.SMEM_BYTES
            or 2 * warps * tiles > ha.RESIDENT_WARPS * ha.NUM_SMS)


@pytest.mark.parametrize("n,f,warps", [
    (100, 44_426, 8),                # phases 3 and 5: a LeNet cohort
    (60, 44_426, 8), (1000, 1000, 16), (100, 1000, 16), (12, 37, 2),
    (16, 1024, 2), (17, 1024, 4), (1, 44_426, 1),
    (4096, 300_000, 1)])             # the grid's warps within one wave
def test_cloud_aggregate_warps_rule(n, f, warps):
    """``cloud_aggregate``: ``block_warps`` at the one-group kernels'
    resident warps (no per-group slots to fit)."""
    assert ha.cloud_aggregate_warps(n, f) == warps
    tiles = -(-f // ha.TILE)
    wave = ha.ONE_GROUP_RESIDENT_WARPS * ha.NUM_SMS
    assert warps == 1 or warps * tiles <= wave
    assert (warps == ha.MAX_WARPS or warps * ha.WARP_ROWS >= n
            or 2 * warps * tiles > wave)


# (F, element size, byte offset of x from an aligned base) -> elements a load
@pytest.mark.parametrize("f,size,offset,vec", [
    (1024, 4, 0, 4),                 # the streaming chunk: 16-byte loads
    (44_426, 4, 0, 2),               # LeNet: the pitch is 8 x 22,213 bytes
    (44_426, 4, 44_426 * 4, 2),      # a view from an odd row: 8-aligned
    (1001, 4, 0, 1),                 # odd F: 4-byte loads
    (1024, 4, 8, 2), (1024, 4, 4, 1),
    (1024, 2, 0, 4),                 # bf16: 8-byte loads of 4 values
    (44_426, 2, 0, 2),
    (44_426, 2, 44_426 * 2, 2),      # bf16, odd row: 4-byte aligned
    (1001, 2, 0, 1), (1024, 2, 2, 1)])
def test_load_width(f, size, offset, vec):
    assert ha.load_width(f, size, 1 << 20 | offset) == vec
    assert f % vec == 0 and offset % (vec * size) == 0


def test_flat_staleness_merge_matches_reference():
    rng = np.random.default_rng(0)
    n, f = 12, 29
    g = rng.normal(0, 1, f).astype(np.float32)
    buf = rng.normal(0, 1, (n, f)).astype(np.float32)
    w = rng.uniform(50, 120, n).astype(np.float32)
    decay = np.where(np.arange(n) % 3 == 0, 0.0, 0.9 ** (np.arange(n) % 4))
    eff = (w * decay).astype(np.float32)
    w_total = float(w.sum())
    ref = j_agg.flat_staleness_merge(jnp.asarray(g), jnp.asarray(buf), eff,
                                     w_total)
    out = t_agg.flat_staleness_merge(torch.from_numpy(g),
                                     torch.from_numpy(buf), eff, w_total)
    assert out.dtype == torch.float32 and tuple(out.shape) == (f,)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # every edge arriving fresh is eq. 10 on the buffer
    full = t_agg.flat_staleness_merge(torch.from_numpy(g),
                                      torch.from_numpy(buf), w, w_total)
    np.testing.assert_allclose(
        full.numpy(), (w[:, None] * buf).sum(0) / w.sum(), **TOL)


@pytest.mark.parametrize("dead", [(), (1,), (0, 1, 2)],
                         ids=["all_alive", "one_dead_cohort", "all_dead"])
def test_survivor_weights_match_reference(dead):
    rng = np.random.default_rng(1)
    n, m = 15, 3
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    g = np.arange(n) % m
    surv = rng.random(n) < 0.6
    surv[:m] = True
    for e in dead:
        surv[g == e] = False
    ref = np.asarray(j_agg.survivor_weights(w, surv, g, m))
    out = t_agg.survivor_weights(w, surv, g, m)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    for e in dead:
        assert (out[torch.from_numpy(g == e)] == 0).all()
    for e in set(range(m)) - set(dead):
        np.testing.assert_allclose(float(out[torch.from_numpy(g == e)].sum()),
                                   float(w[g == e].sum()), rtol=1e-5)


@pytest.mark.parametrize("chunk", [1, 7, None], ids=["c1", "c7", "cN"])
def test_streaming_matches_one_shot_in_both_packages(chunk):
    """Mirrors ``tests/test_sampling_props.py::test_streaming_matches_batch``
    with a memberless edge added."""
    rng = np.random.default_rng(3)
    n, f, m = 33, 24, 5
    buf = rng.normal(0, 1, (n, f)).astype(np.float32)
    w = rng.uniform(0.1, 2.0, n).astype(np.float32)
    w[4] = 0.0
    gid = rng.integers(0, m - 1, n).astype(np.int32)    # edge m-1: no members
    j_ref = np.asarray(j_agg.flat_edge_aggregate(jnp.asarray(buf), w, gid, m,
                                                 use_kernel=False))
    tbuf = torch.from_numpy(buf)
    t_ref = t_agg.flat_edge_aggregate(tbuf, w, gid, m).numpy()
    out = t_agg.streaming_edge_aggregate(tbuf, w, gid, m,
                                         chunk_size=chunk or n).numpy()
    j_out = np.asarray(j_agg.streaming_edge_aggregate(
        jnp.asarray(buf), w, gid, m, chunk_size=chunk or n,
        use_kernel=False))
    np.testing.assert_allclose(out, j_ref, **TOL)
    np.testing.assert_allclose(out, t_ref, **TOL)
    np.testing.assert_allclose(out, j_out, **TOL)


def test_accumulator_matches_reference():
    rng = np.random.default_rng(4)
    m, f = 4, 16
    j_acc = j_agg.StreamingEdgeAccumulator(m, f, use_kernel=False)
    t_acc = t_agg.StreamingEdgeAccumulator(m, f, device="cpu")
    for n in (5, 1, 9):
        x = rng.normal(0, 1, (n, f)).astype(np.float32)
        w = rng.uniform(0.5, 1.0, n).astype(np.float32)
        g = rng.integers(0, m - 1, n)                   # edge m-1 stays empty
        j_acc.add(jnp.asarray(x), w, g)
        assert t_acc.add(torch.from_numpy(x), w, g) is t_acc
    np.testing.assert_allclose(t_acc.num.numpy(), np.asarray(j_acc.num),
                               **TOL)
    np.testing.assert_allclose(t_acc.mass.numpy(), np.asarray(j_acc.mass),
                               **TOL)
    means = t_acc.edge_means()
    np.testing.assert_allclose(means.numpy(), np.asarray(j_acc.edge_means()),
                               **TOL)
    assert (means[m - 1] == 0).all()
    np.testing.assert_allclose(t_acc.cloud_mean().numpy(),
                               np.asarray(j_acc.cloud_mean()), **TOL)
    ids = np.array([3, 0, 2, 2])
    np.testing.assert_allclose(t_acc.scatter(ids).numpy(),
                               np.asarray(j_acc.scatter(ids)), **TOL)
    assert t_acc.resident_bytes() == j_acc.resident_bytes()
    assert t_acc.resident_bytes() == m * f * 4 + m * 4
    assert t_acc.reset() is t_acc
    assert (t_acc.num == 0).all() and (t_acc.mass == 0).all()
    assert (t_acc.edge_means() == 0).all()


def test_accumulator_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_agg.StreamingEdgeAccumulator(2, 8)
