"""The port's data-sharded flat buffer against the JAX package.

* ``_pack_groups`` equals the reference's bit for bit (pure numpy), and
  ``ShardedFlatLayout``'s padded form and round trips are exact.
* ``flat_edge_aggregate(mesh=)`` / ``flat_cloud_aggregate(mesh=)`` on gloo
  ranks on the CPU (``run_ranks``), each rank passing its own slab: the
  assembled slabs within 1e-5 of the reference's single-device events
  (``tests/test_fl_shard.py``'s ``AGG_SCRIPT`` inputs) and of a float64
  oracle, on every listed mesh, a padding-only shard included.
* ``HFLSimulator(mesh=)``, sync, ``gd`` and ``dane``: within 1e-5 of the
  reference's single-device run (``SIM_SCRIPT``'s inputs) and of the
  port's own unsharded run.  The reference's own sharded run equals its
  single-device run (``test_simulator_mesh_trajectory_parity``); its
  kernel route under a mesh does not run on the installed JAX, so the
  single-device run is the oracle.

The ranks run the module-level ``_*_rank`` functions: ``spawn`` imports
this module in every rank, so JAX is imported only inside the tests.
Every spawn has its own timeout (``SPAWN_TIMEOUT_S``), and so do the
process groups.
"""
import datetime
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.fl import aggregate as t_agg  # noqa: E402
from repro_torch.fl.flatten import (  # noqa: E402
    FlatLayout, ShardedFlatLayout, _pack_groups, tree_leaves)
from repro_torch.kernels import hier_aggregate as ha  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    AggMesh, make_agg_mesh, run_ranks)

SPAWN_TIMEOUT_S = 120
TOL = dict(rtol=0, atol=1e-5)

# AGG_SCRIPT's inputs: F = 1001 is odd, so every model axis pads columns;
# group 1 has no member.
N, F, M = 24, 1001, 3
AGG_MESHES = [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 1, "3 groups")]
SIM_MESHES = [(2, 1), (1, 2), (2, 2)]


def _agg_inputs(three_groups=False):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (N, F)).astype(np.float32)
    w = rng.uniform(1, 5, N).astype(np.float32)
    gid = rng.choice([0, 2], N).astype(np.int32)
    if three_groups:         # 3 edges on 4 shards: one shard is padding only
        gid = (np.arange(N) % 3).astype(np.int32)
    return x, w, gid


def _fake_mesh(d, m, di=0, mi=0):
    return AggMesh(num_data=d, num_model=m, data_index=di, model_index=mi,
                   device=torch.device("cpu"))


def _timeout():
    return datetime.timedelta(seconds=SPAWN_TIMEOUT_S)


class _Calls:
    """Counts calls of the kernel wrappers on the CPU, where they take the
    plain versions and launch nothing."""
    NAMES = ("segment_aggregate", "cloud_aggregate", "weighted_mean")

    def __enter__(self):
        self.mocks = {n: mock.patch.object(ha, n, wraps=getattr(ha, n))
                      for n in self.NAMES}
        self.calls = {n: p.start() for n, p in self.mocks.items()}
        return self

    def __exit__(self, *exc):
        for p in self.mocks.values():
            p.stop()

    def counts(self):
        return {n: m.call_count for n, m in self.calls.items()}


# ---------------------------------------------------------------------------
# Rank functions (run in spawned ranks).
# ---------------------------------------------------------------------------


def _agg_rank(meshes):
    torch.set_num_threads(1)
    out = {}
    for case in meshes:
        d, m = case[:2]
        x, w, gid = _agg_inputs(len(case) > 2)
        mesh = make_agg_mesh(m, d, device="cpu", timeout=_timeout())
        layout = FlatLayout.of({"a": torch.from_numpy(x).reshape(N, 7, 143)})
        sl = ShardedFlatLayout.build(layout, mesh, N, group_ids=gid)
        buf = sl.local(sl.pad(torch.from_numpy(x)))
        lw = sl.local(sl.pad_weights(w))
        lg = sl.local(sl.pad_rows(torch.from_numpy(gid)))
        before = dict(ha.launch_counts)
        with _Calls() as calls:
            edge = t_agg.flat_edge_aggregate(buf, lw, lg, M, mesh=mesh)
            cloud = t_agg.flat_cloud_aggregate(buf, lw, mesh=mesh)
        out[case] = dict(edge=edge.numpy(), cloud=cloud.numpy(),
                         calls=calls.counts(),
                         launched=ha.launch_counts != before,
                         rows=sl.local_rows, cols=sl.local_cols,
                         den=float(lw.sum()))
    return out


def _sim_rank(cases, sim_args):
    from repro_torch.core import plan
    from repro_torch.core.problem import HFLProblem
    from repro_torch.fl.sim import HFLSimulator
    from repro_torch.models import lenet
    torch.set_num_threads(1)
    prob_kw, init, ue_data, test = sim_args
    sch = plan(HFLProblem(**prob_kw))
    out = {}
    for d, m, solver in cases:
        mesh = make_agg_mesh(m, d, device="cpu", timeout=_timeout())
        params = {k: torch.tensor(v) for k, v in init.items()}
        sim = HFLSimulator(sch, lambda p, b: lenet.logreg_loss(p, b, l2=1e-3),
                           params, ue_data, lr=0.02, solver=solver,
                           mesh=mesh, device="cpu")
        with _Calls() as calls:
            res = sim.run(test, rounds=2)
        out[(d, m, solver)] = dict(
            test_acc=res.test_acc, test_loss=res.test_loss,
            train_loss=res.train_loss, times=res.times,
            final=[t.numpy() for t in tree_leaves(res.final_params)],
            params=[t.numpy() for t in tree_leaves(sim.params)],
            calls=calls.counts(), slab=tuple(sim._flat.shape),
            b=sch.b)
    return out


def _failing_rank():
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    return "ok"


def _hanging_rank():
    import time

    import torch.distributed as dist
    if dist.get_rank() == 0:
        dist.all_reduce(torch.ones(1))   # rank 1 never joins
    time.sleep(3 * SPAWN_TIMEOUT_S)


def _mesh_checks():
    errors = []
    try:
        make_agg_mesh(3, 1, device="cpu")
    except ValueError as e:
        errors.append(str(e))
    mesh = make_agg_mesh(2, 1, device="cpu", timeout=_timeout())
    return errors, (mesh.rank, mesh.data_index, mesh.model_index,
                    mesh.shape, mesh.size), torch.full((3,), mesh.rank)


def _world_rank(agg_cases, sim_cases, sim_args):
    """One spawn's work: the aggregation and simulator meshes of its world
    size, and with two ranks the mesh checks."""
    import torch.distributed as dist
    return dict(agg=_agg_rank(agg_cases),
                sim=_sim_rank(sim_cases, sim_args) if sim_cases else {},
                checks=_mesh_checks() if dist.get_world_size() == 2 else None)


# ---------------------------------------------------------------------------
# Layout: pure host math against the reference.
# ---------------------------------------------------------------------------


def _group_ids(kind, shards):
    rng = np.random.default_rng(shards)
    if kind == "random":
        return rng.integers(0, 5, 40)
    if kind == "unbalanced":
        return np.repeat([3, 0, 1, 4, 2], [17, 1, 9, 2, 9])
    if kind == "empty_groups":           # ids 1, 4, 5 have no member
        return rng.choice([0, 2, 3, 6], 31)
    if kind == "ties":                   # equal sizes: argmin's first shard
        return np.repeat([2, 0, 1, 3], 5)
    return np.zeros(7, np.int64)         # one group


@pytest.mark.parametrize("shards", range(1, 9))
@pytest.mark.parametrize("kind", ["random", "unbalanced", "empty_groups",
                                  "ties", "one_group"])
def test_pack_groups_matches_reference_bit_for_bit(kind, shards):
    from repro.fl.flatten import _pack_groups as j_pack
    gid = _group_ids(kind, shards)
    perm, n_padded = _pack_groups(gid, shards)
    j_perm, j_n = j_pack(gid, shards)
    assert n_padded == j_n and perm.dtype == j_perm.dtype
    np.testing.assert_array_equal(perm, j_perm)
    # every edge on exactly one shard, every row exactly once
    per = n_padded // shards
    for g in np.unique(gid):
        slots = np.flatnonzero(np.isin(perm, np.flatnonzero(gid == g)))
        assert len(set(slots // per)) == 1
    assert sorted(perm[perm >= 0]) == list(range(len(gid)))


def test_sharded_layout_padding_round_trip_single_device():
    """tests/test_fl_shard.py:362's case: a 1 x 1 mesh pads nothing."""
    rng = np.random.default_rng(3)
    n, f = 10, 37
    x = torch.from_numpy(rng.normal(0, 1, (n, f)).astype(np.float32))
    gid = np.asarray([0, 0, 0, 0, 0, 1, 1, 2, 2, 2])
    sl = ShardedFlatLayout.build(FlatLayout.of({"a": x}), _fake_mesh(1, 1),
                                 num_rows=n, group_ids=gid)
    assert sl.f_padded == f and sl.n_padded == n
    assert torch.equal(sl.unpad(sl.pad(x)), x)
    w = torch.from_numpy(rng.uniform(1, 2, n).astype(np.float32))
    assert torch.equal(sl.pad_weights(w), w)
    assert torch.equal(sl.local(sl.pad(x)), x)


@pytest.mark.parametrize("d,m", [(2, 1), (1, 2), (2, 2), (4, 1), (3, 2),
                                 (1, 8)])
def test_sharded_layout_matches_reference_and_round_trips(d, m):
    import jax.numpy as jnp

    from repro.fl.flatten import FlatLayout as JFlatLayout
    from repro.fl.flatten import ShardedFlatLayout as JSharded

    class _Shape:                    # the reference reads only mesh.shape
        shape = {"data": d, "model": m}

    x, w, gid = _agg_inputs()
    tx = torch.from_numpy(x)
    stacked = {"a": tx.reshape(N, 7, 143), "b": tx[:, :2].contiguous()}
    base = FlatLayout.of(stacked)
    sl = ShardedFlatLayout.build(base, _fake_mesh(d, m), N, group_ids=gid)
    jl = JSharded.build(JFlatLayout.of({k: jnp.asarray(v.numpy())
                                        for k, v in stacked.items()}),
                        _Shape(), N, group_ids=gid)
    assert (sl.n_padded, sl.f_padded) == (jl.n_padded, jl.f_padded)
    np.testing.assert_array_equal(sl.perm, jl.perm)
    np.testing.assert_array_equal(sl.inv_perm, jl.inv_perm)
    assert sl.per_device_bytes() == jl.per_device_bytes()
    flat = base.ravel(stacked)
    padded = sl.pad(flat)
    np.testing.assert_array_equal(
        padded.numpy(), np.asarray(jl.pad(jnp.asarray(flat.numpy()))))
    assert sl.f_padded % m == 0 and sl.n_padded % d == 0
    assert (padded[:, base.total:] == 0).all()
    assert torch.equal(sl.unpad(padded), flat)
    assert torch.equal(sl.ravel(stacked), padded)
    for k, v in sl.unravel(padded).items():
        assert torch.equal(v, stacked[k])
    hot = sl.ravel_padded(sl.unravel_padded(padded))
    assert torch.equal(hot, padded)
    # per-row helpers: pad rows are row-0 copies with weight 0 and mask False
    pw = sl.pad_weights(w)
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jl.pad_weights(w)))
    assert (pw[torch.from_numpy(sl.perm < 0)] == 0).all()
    mask = np.ones(N, bool)
    pm = sl.pad_mask(mask)
    np.testing.assert_array_equal(pm.numpy(), sl.perm >= 0)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jl.pad_mask(mask)))
    np.testing.assert_array_equal(sl.pad_rows(gid), np.asarray(
        jl.pad_rows(jnp.asarray(gid))))
    assert torch.equal(sl.pad_rows(torch.from_numpy(gid)),
                       torch.from_numpy(sl.pad_rows(gid)))
    rows = np.flatnonzero(sl.perm >= 0)[::3]
    got = sl.gather_rows(padded, rows)
    assert torch.equal(sl.scatter_rows(padded, rows, got), padded)
    assert torch.equal(sl.scatter_rows(padded, rows, got * 0)[rows], got * 0)
    # the ranks' slabs tile the padded buffer exactly once
    rebuilt = torch.full_like(padded, float("nan"))
    for r in range(d * m):
        part = ShardedFlatLayout.build(base, _fake_mesh(d, m, *divmod(r, m)),
                                       N, group_ids=gid)
        slab = part.local(padded)
        assert slab.is_contiguous()
        assert slab.numel() * 4 == sl.per_device_bytes()
        assert torch.isnan(rebuilt[part.local_rows, part.local_cols]).all()
        rebuilt[part.local_rows, part.local_cols] = slab
        assert torch.equal(part.local(pw), pw[part.local_rows])
    assert torch.equal(rebuilt, padded)


def test_data_sharding_needs_group_ids():
    with pytest.raises(ValueError, match="group_ids"):
        ShardedFlatLayout.build(FlatLayout.of({"a": torch.zeros(4, 3)}),
                                _fake_mesh(2, 1), 4)


# ---------------------------------------------------------------------------
# Sharded aggregation on gloo ranks.
# ---------------------------------------------------------------------------


def _assemble(results, key, n_padded, f_padded):
    out = np.full((n_padded, f_padded), np.nan, np.float32)
    for r in results:
        out[r["rows"], r["cols"]] = r[key]
    return out


@pytest.mark.parametrize("case", AGG_MESHES,
                         ids=lambda c: "x".join(map(str, c[:2])) +
                         ("-3groups" if len(c) > 2 else ""))
def test_sharded_aggregation_matches_reference_and_oracle(rank_runs, case):
    import jax.numpy as jnp

    from repro.fl import aggregate as j_agg
    d, m = case[:2]
    x, w, gid = _agg_inputs(len(case) > 2)
    # the reference's single-device events, and a float64 oracle
    jx, jw, jg = jnp.asarray(x), jnp.asarray(w), jnp.asarray(gid)
    single_edge = np.asarray(j_agg.flat_edge_aggregate(jx, jw, jg, M))
    single_cloud = np.asarray(j_agg.flat_cloud_aggregate(jx, jw))
    w64, x64 = w.astype(np.float64), x.astype(np.float64)
    oracle_edge = np.zeros_like(x64)
    for g in range(M):
        rows = gid == g
        if rows.any():
            oracle_edge[rows] = (w64[rows, None] * x64[rows]).sum(0) / \
                w64[rows].sum()
    oracle_cloud = np.broadcast_to((w64[:, None] * x64).sum(0) / w64.sum(),
                                   x64.shape)

    results = rank_runs["agg", case]
    sl = ShardedFlatLayout.build(
        FlatLayout.of({"a": torch.from_numpy(x)}), _fake_mesh(d, m), N,
        group_ids=gid)
    for key, single, oracle in (("edge", single_edge, oracle_edge),
                                ("cloud", single_cloud, oracle_cloud)):
        padded = _assemble(results, key, sl.n_padded, sl.f_padded)
        assert np.isfinite(padded).all()       # pad rows and pad columns too
        got = sl.unpad(torch.from_numpy(padded)).numpy()
        np.testing.assert_allclose(got, single, **TOL)
        np.testing.assert_allclose(got, oracle, **TOL)
    # the cloud event went through K3 on every data shard when there are
    # several, through K2 otherwise; the edge event through K1; on the CPU
    # the wrappers take the plain versions and launch nothing
    for r in results:
        assert r["calls"] == dict(segment_aggregate=1,
                                  cloud_aggregate=int(d == 1),
                                  weighted_mean=int(d > 1))
        assert not r["launched"]
    if len(case) > 2:
        assert sorted(r["den"] == 0 for r in results) == [False] * 3 + [True]


# ---------------------------------------------------------------------------
# The simulator on gloo ranks.
# ---------------------------------------------------------------------------


QUICKSTART = dict(num_edges=2, num_ues=8, epsilon=0.25, seed=0,
                  samples_lo=50, samples_hi=120)


@pytest.fixture(scope="module")
def sim_setup():
    import jax

    from repro.models import lenet as j_lenet
    from repro_torch.core import plan
    from repro_torch.core.problem import HFLProblem
    from repro_torch.data import partition, synthetic
    sch = plan(HFLProblem(**QUICKSTART))
    train = synthetic.logreg_data(seed=0, n=800, dim=12, num_classes=4)
    test = synthetic.logreg_data(seed=1, n=200, dim=12, num_classes=4)
    parts = partition.size_partition(np.random.default_rng(0), 800,
                                     sch.problem.samples.astype(int))
    ue_data = [{k: train[k][ix] for k in train} for ix in parts]
    init = jax.tree.map(np.asarray,
                        j_lenet.logreg_init(jax.random.PRNGKey(0), 12, 4))
    return QUICKSTART, init, ue_data, test


@pytest.fixture(scope="module")
def rank_runs(sim_setup):
    """Every listed aggregation and simulator mesh, one spawn per world
    size: {("agg" | "sim", case): [each rank's result]}, and the 2-rank
    spawn's mesh checks under "checks"."""
    sim_cases = [(d, m, s) for d, m in SIM_MESHES for s in ("gd", "dane")]
    runs = {}
    for world in (1, 2, 4):
        agg = [c for c in AGG_MESHES if c[0] * c[1] == world]
        sim = [c for c in sim_cases if c[0] * c[1] == world]
        per_rank = run_ranks(_world_rank, world, agg, sim, sim_setup,
                             device="cpu", timeout_s=SPAWN_TIMEOUT_S)
        for kind, cases in (("agg", agg), ("sim", sim)):
            for c in cases:
                runs[kind, c] = [r[kind][c] for r in per_rank]
        if world == 2:
            runs["checks"] = [r["checks"] for r in per_rank]
    return runs


@pytest.fixture(scope="module")
def single_runs(sim_setup):
    """{solver: (reference single-device result, port unsharded result)}."""
    import jax

    from repro.core import plan as j_plan
    from repro.core.problem import HFLProblem as JProblem
    from repro.fl.sim import HFLSimulator as JSim
    from repro.models import lenet as j_lenet
    from repro_torch.core import plan
    from repro_torch.core.problem import HFLProblem
    from repro_torch.fl.sim import HFLSimulator
    from repro_torch.models import lenet
    prob_kw, init, ue_data, test = sim_setup
    out = {}
    for solver in ("gd", "dane"):
        jsim = JSim(j_plan(JProblem(**prob_kw)),
                    lambda p, b: j_lenet.logreg_loss(p, b, l2=1e-3), init,
                    ue_data, lr=0.02, solver=solver)
        jres = jsim.run(test, rounds=2)
        jref = dict(test_acc=jres.test_acc, test_loss=jres.test_loss,
                    train_loss=jres.train_loss, times=jres.times,
                    params=[np.asarray(t) for t in jax.tree.leaves(
                        jsim.params)])
        tsim = HFLSimulator(plan(HFLProblem(**prob_kw)),
                            lambda p, b: lenet.logreg_loss(p, b, l2=1e-3),
                            {k: torch.tensor(v) for k, v in init.items()},
                            ue_data, lr=0.02, solver=solver, device="cpu")
        tres = tsim.run(test, rounds=2)
        tref = dict(test_acc=tres.test_acc, test_loss=tres.test_loss,
                    train_loss=tres.train_loss, times=tres.times,
                    params=[t.numpy() for t in tree_leaves(tsim.params)],
                    final=[t.numpy() for t in tree_leaves(
                        tres.final_params)])
        out[solver] = (jref, tref)
    return out


@pytest.mark.parametrize("solver", ["gd", "dane"])
@pytest.mark.parametrize("d,m", SIM_MESHES)
def test_sharded_simulator_matches_reference_single_device(
        rank_runs, single_runs, d, m, solver):
    jref, tref = single_runs[solver]
    ranks = rank_runs["sim", (d, m, solver)]
    first = ranks[0]
    for oracle in (jref, tref):
        np.testing.assert_array_equal(first["times"], oracle["times"])
        for key in ("test_acc", "test_loss", "train_loss"):
            np.testing.assert_allclose(first[key], oracle[key], **TOL)
        for a, b in zip(first["params"], oracle["params"]):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, **TOL)
    for a, b in zip(first["final"], tref["final"]):
        np.testing.assert_allclose(a, b, **TOL)
    # the same SimResult and global params on every rank
    for r in ranks[1:]:
        for key in ("test_acc", "test_loss", "train_loss", "times"):
            np.testing.assert_array_equal(r[key], first[key])
        for a, b in zip(r["params"] + r["final"],
                        first["params"] + first["final"]):
            np.testing.assert_array_equal(a, b)
    # each rank holds one slab; b edge events and one cloud event a round
    n_rows = {1: 8}.get(d)
    for r in ranks:
        assert r["slab"][1] == 52 // m
        if n_rows:
            assert r["slab"][0] == n_rows
        assert r["calls"] == dict(segment_aggregate=2 * r["b"],
                                  cloud_aggregate=2 * int(d == 1),
                                  weighted_mean=2 * int(d > 1))


# ---------------------------------------------------------------------------
# The mesh and the spawn helper.
# ---------------------------------------------------------------------------


def test_async_with_mesh_raises_naming_item_13b():
    from repro_torch.core import plan
    from repro_torch.core.problem import HFLProblem
    from repro_torch.fl.sim import HFLSimulator
    with pytest.raises(NotImplementedError, match="item 13b"):
        HFLSimulator(plan(HFLProblem(**QUICKSTART)), None, {}, [{}] * 8,
                     mode="async", mesh=_fake_mesh(2, 1), device="cpu")


def test_make_agg_mesh_needs_a_process_group_of_its_size(rank_runs):
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_agg_mesh(1, 1, device="cpu")
    errors, coords, tensors = zip(*rank_runs["checks"])
    assert all("needs 3 ranks" in e[0] for e in errors)
    assert coords == ((0, 0, 0, {"data": 1, "model": 2}, 2),
                      (1, 0, 1, {"data": 1, "model": 2}, 2))
    # a rank's tensors come back by value, after the rank has exited
    assert [t.tolist() for t in tensors] == [[0, 0, 0], [1, 1, 1]]


def test_run_ranks_reraises_a_rank_failure():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(_failing_rank, 2, device="cpu", timeout_s=SPAWN_TIMEOUT_S)


def test_run_ranks_cuts_a_hung_collective():
    """Rank 1 never joins rank 0's all-reduce: whichever comes first, the
    process group's timeout or the run's, the call ends with an error."""
    import time
    t0 = time.monotonic()
    with pytest.raises((TimeoutError, RuntimeError)):
        run_ranks(_hanging_rank, 2, device="cpu", timeout_s=5)
    assert time.monotonic() - t0 < 60
