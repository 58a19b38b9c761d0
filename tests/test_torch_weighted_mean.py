"""K3's plain version, ``weighted_mean_plain`` (the reduce-only weighted
mean of a data shard's slab), against the JAX package's Pallas kernel
``ops.hier_aggregate`` (interpret mode on the CPU, as
``tests/test_kernels.py`` runs it) and its ``ref.hier_aggregate_ref``
oracle, on the reference's ``AGG_CASES``: rtol 1e-5, atol 5e-5, the
reference's own tolerance (the sums run in other orders).  Also the CPU
wrapper, its input checks and the kernel's launch plan.  The CUDA kernel
itself is held to the plain version in ``test_torch_kernels.py``, on a
card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import hier_aggregate as ha  # noqa: E402

TOL = dict(rtol=1e-5, atol=5e-5)
# tests/test_kernels.py:85: N > 512 takes the TPU kernel's client-blocked
# route (600, 1030)
AGG_CASES = [(8, (1000,)), (33, (7, 13)), (600, (256,)), (4, (3, 5, 7)),
             (1030, (64,)), (2, (1,))]


def _inputs(n, shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n,) + shape).astype(np.float32)
    w = rng.uniform(1, 10, n).astype(np.float32)
    return x, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", AGG_CASES,
                         ids=lambda c: f"N{c[0]}-{'x'.join(map(str, c[1]))}")
def test_weighted_mean_plain_matches_pallas_and_ref(case, dtype):
    n, shape = case
    x, w = _inputs(n, shape, n)
    jx = jnp.asarray(x, dtype=jnp.bfloat16 if dtype == "bfloat16" else None)
    tx = torch.from_numpy(x).reshape(n, -1)
    if dtype == "bfloat16":
        tx = tx.to(torch.bfloat16)
    # both packages round the same fp32 values to the same bf16 values
    np.testing.assert_array_equal(tx.float().numpy(),
                                  np.asarray(jx, np.float32).reshape(n, -1))
    out = ha.weighted_mean_plain(tx, torch.from_numpy(w))
    assert out.dtype == torch.float32 and tuple(out.shape) == (tx.shape[1],)
    jw = jnp.asarray(w)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(ops.hier_aggregate(jx, jw)).reshape(-1), **TOL)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(ref.hier_aggregate_ref(jx, jw)).reshape(-1),
        **TOL)


@pytest.mark.parametrize("n,f", [(2, 1), (7, 300), (40, 129), (513, 17)])
def test_weighted_mean_of_identical_rows_is_the_row(n, f):
    """tests/test_kernels.py:104's property: the weighted mean of identical
    rows is the row, whatever the weights."""
    rng = np.random.default_rng(n * 1000 + f)
    row = torch.from_numpy(rng.normal(0, 1, f).astype(np.float32))
    x = row[None].expand(n, f).contiguous()
    w = torch.from_numpy(rng.uniform(0.5, 3.0, n).astype(np.float32))
    np.testing.assert_allclose(ha.weighted_mean(x, w).numpy(), row.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_all_zero_weights_give_nan_as_the_reference():
    """No 1e-12 guard: 0/0, as ``ref.hier_aggregate_ref`` (the sharded cloud
    event guards an all-padding shard itself)."""
    x, _ = _inputs(5, (4,), 0)
    w = np.zeros(5, np.float32)
    out = ha.weighted_mean_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert out.isnan().all()
    assert np.isnan(np.asarray(ref.hier_aggregate_ref(jnp.asarray(x),
                                                      jnp.asarray(w)))).all()


def test_cpu_wrapper_takes_plain_version_without_launching():
    x, w = _inputs(33, (91,), 1)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    before = dict(ha.launch_counts)
    assert torch.equal(ha.weighted_mean(tx, tw),
                       ha.weighted_mean_plain(tx, tw))
    assert ha.launch_counts == before


@pytest.mark.parametrize("bad", ["x_1d", "x_3d", "x_f64", "x_int", "w_f64",
                                 "w_len", "w_2d", "x_strided", "w_strided"])
def test_wrapper_rejects_inputs_the_kernel_does_not_take(bad):
    x = torch.zeros(6, 8)
    w = torch.ones(6)
    if bad == "x_1d":
        x = x[0]
    elif bad == "x_3d":
        x = x[None]
    elif bad == "x_f64":
        x = x.double()
    elif bad == "x_int":
        x = x.int()
    elif bad == "w_f64":
        w = w.double()
    elif bad == "w_len":
        w = w[:5]
    elif bad == "w_2d":
        w = w[:, None]
    elif bad == "x_strided":
        x = torch.zeros(6, 16)[:, ::2]
    elif bad == "w_strided":
        w = torch.ones(12)[::2]
    with pytest.raises((ValueError, TypeError)):
        ha.weighted_mean(x, w)


# (N, F): the paths' shapes (phase 9's slab, a fleet-scale shard), the
# LeNet cohort, few columns over many rows, and the edges
PLAN_CASES = [(0, 5), (1, 3), (60, 44_426), (100, 44_426), (513, 1001),
              (16_384, 44_426), (16_384, 1024), (1 << 20, 64), (4096, 44_426),
              (12, 37), (600, 37), (40, 300)]


def _wave(warps):
    """Blocks of ``warps`` warps that the card holds at once."""
    return ha.NUM_SMS * (ha.ONE_GROUP_RESIDENT_WARPS // warps)


@pytest.mark.parametrize("n,f", PLAN_CASES)
def test_slice_rule_covers_every_row_once(n, f):
    """``weighted_mean_plan``: the slices cover the rows once, the last
    not empty, and the warps a block are a power of two within the kernel's
    ``MAX_WARPS``."""
    slices, rows, warps = ha.weighted_mean_plan(n, f)
    assert slices >= 1 and rows >= 1
    assert slices * rows >= n and (slices - 1) * rows < max(n, 1)
    assert 1 <= warps <= ha.MAX_WARPS and warps & (warps - 1) == 0


@pytest.mark.parametrize("n,f", PLAN_CASES)
def test_mean_plan_fills_whole_waves(n, f):
    """The grid (a block a column tile and slice) stays within
    ``MEAN_WAVES`` waves of the warps an SM holds, and where the waves
    set the slices it fills them to within one slice of tiles: no last
    wave short of blocks but by less than a slice.  A warp a
    ``WARP_ROWS`` rows up to ``MEAN_WARPS``; a sliced plan gives every
    warp at least ``WARP_ROWS`` rows (its loads in flight at once), and
    at most ``MEAN_MAX_SLICES`` slices."""
    slices, rows, warps = ha.weighted_mean_plan(n, f)
    tiles = -(-f // ha.TILE)
    assert warps == ha.MEAN_WARPS or warps * ha.WARP_ROWS >= n
    assert warps == 1 or (warps // 2) * ha.WARP_ROWS < n
    assert slices <= ha.MEAN_MAX_SLICES
    if slices == 1:
        return
    waves = ha.MEAN_WAVES * _wave(warps)
    assert rows >= warps * ha.WARP_ROWS
    assert tiles * slices <= waves
    if slices < min(ha.MEAN_MAX_SLICES, n // (warps * ha.WARP_ROWS)):
        assert tiles * (slices + 1) > waves


@pytest.mark.parametrize("n,f,slices,rows,warps", [
    (60, 44_426, 1, 60, 8),            # phase 9's slab: the tiles fill it
    (100, 44_426, 1, 100, 8),          # a LeNet cohort: as many
    (16_384, 44_426, 12, 1366, 8),     # the fleet shard: 4,176 of 4,224
    (16_384, 1024, 32, 512, 8),        # 8 tiles: MEAN_MAX_SLICES
    (12, 37, 1, 12, 2), (1, 1001, 1, 1, 1)])
def test_mean_plan_at_the_paths_shapes(n, f, slices, rows, warps):
    """One slice when the rows are fewer than two batches a warp (phase
    9's slab), row slices for whole waves when there are many (the fleet
    shard)."""
    assert ha.weighted_mean_plan(n, f) == (slices, rows, warps)
