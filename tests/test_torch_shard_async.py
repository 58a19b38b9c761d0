"""Async Algorithm 1, its replay hooks and streaming on a mesh of gloo ranks
(CPU), against the JAX package.

* ``HFLSimulator(mode="async", mesh=)`` at ``max_staleness`` 0 and 2 on
  the meshes (1,1), (2,1), (1,2), (2,2) and (4,1), on the quickstart logreg
  problem (``tests/test_fl_shard.py``'s ``ASYNC_SIM_SCRIPT``): the trace
  and the clock equal the reference's single-device run's, the losses,
  the final model and the stacked params within 1e-5; every rank returns
  the same result; each wave is ``b`` edge events and no cloud event.
  (The reference's own mesh run fails on the installed JAX, so its
  single-device run is the oracle.)
* Every replay hook on each mesh, in the reference's global coordinates
  (``(F_hot,)`` cloud vectors, masks and row indices over the padded
  rows), against the same hook on the port's single-device simulator
  (which ``tests/test_torch_async.py`` holds to the reference): the
  results of every rank equal, and mapped back to the original rows and
  columns within 1e-5 (exact where nothing is summed).
* ``edge_mean_row`` reads a member's row where a padded shard comes
  before the edge's shard (5 edges of 2 UEs on (4,1), UE 0 in edge 2:
  shard 1's pad rows carry edge 2's id and hold 0 after an edge event).
* Streaming over the sharded buffer: each rank streams its own slab
  through ``streaming_edge_aggregate`` at chunks of 1, 7 and its row
  count (``STREAM_SCRIPT``'s inputs: N=24, F=1001, M=3, one empty edge;
  pad rows weigh 0), the assembled slabs within 1e-5 of the reference's
  ``flat_edge_aggregate``.

The ranks run the module-level ``_*rank`` functions (``spawn`` imports
this module in each rank, so JAX is imported only inside the tests), one
spawn per world size, each with its own timeout.
"""
import dataclasses
import datetime
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import plan  # noqa: E402
from repro_torch.core.problem import HFLProblem  # noqa: E402
from repro_torch.fl import aggregate as t_agg  # noqa: E402
from repro_torch.fl.flatten import (FlatLayout,  # noqa: E402
                                    ShardedFlatLayout, tree_leaves)
from repro_torch.fl.sim import HFLSimulator  # noqa: E402
from repro_torch.kernels import hier_aggregate as ha  # noqa: E402
from repro_torch.launch.mesh import make_agg_mesh, run_ranks  # noqa: E402
from repro_torch.models import lenet  # noqa: E402

SPAWN_TIMEOUT_S = 120
ATOL = 1e-5
QUICKSTART = dict(num_edges=2, num_ues=8, epsilon=0.25, seed=0,
                  samples_lo=50, samples_hi=120)
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1)]
STALENESS = (0, 2)
ROUNDS = 2
ROWS = [0, 3, 5, 6]              # original rows the row hooks read
DECAY = [0.9, 0.81]
SURVIVORS = np.array([[1, 0, 1, 1, 0, 1, 1, 0],
                      [0, 1, 1, 0, 1, 1, 0, 1]], bool)
AGG_WEIGHTS = np.linspace(1.0, 2.4, 8).astype(np.float32)
# STREAM_SCRIPT's inputs: F = 1001 pads under a model axis; edge 1 empty
SN, SF, SM = 24, 1001, 3
CHUNKS = ("1", "7", "n_local")
STREAM_MESHES = MESHES[1:]
HOOKS = ["cloud_vector", "replay_departure", "edge_mean_row", "edge_mass",
         "device_rows", "hot_rows", "replay_merge", "hot_survivor_rows",
         "replay_departure_ue_ok", "global_from_vector", "global_params",
         "flat_state", "set_flat_state", "params", "params_setter"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small operations gain nothing from more,
    and idle threads spinning would slow the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _timeout():
    return datetime.timedelta(seconds=SPAWN_TIMEOUT_S)


def _loss(p, b):
    return lenet.logreg_loss(p, b, l2=1e-3)


def _sim(setup, **kw):
    prob_kw, init, ue_data, _ = setup
    return HFLSimulator(plan(HFLProblem(**prob_kw)), _loss,
                        {k: torch.tensor(v) for k, v in init.items()},
                        ue_data, lr=0.02, mode="async", device="cpu", **kw)


def _trace(tl):
    return [(kind, dataclasses.astuple(ev)) for kind, ev in tl.trace]


def _waves(trace):
    """Departure waves the replay runs: the runs of departures that a
    cloud update closes."""
    waves, pending = 0, False
    for kind, _ in trace:
        if kind == "depart":
            pending = True
        elif kind == "update" and pending:
            waves, pending = waves + 1, False
    return waves


class _Calls:
    """Counts calls of the kernel wrappers on the CPU, where they take the
    plain versions and launch nothing."""
    NAMES = ("segment_aggregate", "cloud_aggregate", "weighted_mean",
             "segment_sum")

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


def _numpy(tree):
    return [t.detach().cpu().numpy().copy() for t in tree_leaves(tree)]


def _hot_index(sim, rows):
    """Original row indices as indices into the simulator's padded rows."""
    rows = np.asarray(rows)
    return rows if sim._slayout is None else sim._slayout.inv_perm[rows]


def _hot_weights(sim, w):
    """An original-order weight vector on the padded rows (pads 0)."""
    return w if sim._slayout is None else sim._slayout.pad_weights(w).numpy()


def _hooks(sim):
    """Every replay hook in turn, in the simulator's global coordinates;
    the same script on one device and on every rank of a mesh."""
    out = {}
    gids = sim._hot_gids
    g0 = sim.cloud_vector()
    out["cloud_vector"] = g0.numpy().copy()
    sim.replay_departure(g0, gids == 1)
    out["replay_departure"] = sim.flat_state()
    out["edge_mean_row"] = sim.edge_mean_row(1).numpy().copy()
    out["edge_mass"] = sim.edge_mass(1)
    rows = _hot_index(sim, ROWS)
    out["device_rows"] = sim.device_rows(rows).numpy().copy()
    out["hot_rows"] = sim.hot_rows(rows)
    g1 = sim.replay_merge(sim.place_cloud_vector(out["cloud_vector"]),
                          np.asarray(DECAY))
    out["replay_merge"] = g1.numpy().copy()
    surv = sim.hot_survivor_rows(SURVIVORS)
    out["hot_survivor_rows"] = surv
    sim.replay_departure(g1, np.ones(gids.size, bool), ue_ok=surv[0],
                         agg_weights=_hot_weights(sim, AGG_WEIGHTS))
    out["replay_departure_ue_ok"] = sim.flat_state()
    out["global_from_vector"] = _numpy(sim.global_from_vector(g1))
    out["global_params"] = _numpy(sim.global_params())
    out["flat_state"] = sim.flat_state()
    out["params"] = _numpy(sim.params)
    sim.set_flat_state(out["replay_departure"])
    out["set_flat_state"] = sim.flat_state()
    sim.params = {k: v * 1.5 + 0.25 for k, v in sim.params.items()}
    out["params_setter"] = _numpy(sim.params)
    return out


def _stream_inputs():
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (SN, SF)).astype(np.float32)
    w = rng.uniform(1, 5, SN).astype(np.float32)
    gid = rng.choice([0, 2], SN).astype(np.int32)
    return x, w, gid


def _stream(mesh):
    """Each rank's slab streamed at every chunk size of CHUNKS."""
    x, w, gid = _stream_inputs()
    sl = ShardedFlatLayout.build(
        FlatLayout.of({"a": torch.from_numpy(x).reshape(SN, 7, 143)}),
        mesh, SN, group_ids=gid)
    buf = sl.local(sl.pad(torch.from_numpy(x)))
    lw = sl.local(sl.pad_weights(w))
    lg = sl.local(sl.pad_rows(torch.from_numpy(gid)))
    out = {}
    for name in CHUNKS:
        chunk = buf.shape[0] if name == "n_local" else int(name)
        with _Calls() as calls:
            got = t_agg.streaming_edge_aggregate(buf, lw, lg, SM,
                                                 chunk_size=chunk)
        out[name] = dict(out=got.numpy(), calls=calls.counts(),
                         n_local=buf.shape[0])
    return dict(chunks=out, rows=sl.local_rows, cols=sl.local_cols,
                perm=sl.perm, inv_perm=sl.inv_perm,
                shape=(sl.n_padded, sl.f_padded))


PAD_FIRST_GIDS = np.array([2, 2, 0, 0, 1, 1, 3, 3, 4, 4])


def _pad_first_rows(mesh=None):
    """Every edge's mean row after one wave, on a schedule whose UE 0 sits
    in an edge that a padded shard precedes on (4,1)."""
    from repro_torch.data import partition, synthetic
    prob = HFLProblem(num_edges=5, num_ues=10, seed=0, samples_lo=50,
                      samples_hi=120)
    sch = dataclasses.replace(plan(prob),
                              assoc=np.eye(5, dtype=int)[PAD_FIRST_GIDS])
    n = int(prob.samples.sum())
    train = synthetic.logreg_data(seed=0, n=n, dim=12, num_classes=4)
    parts = partition.size_partition(np.random.default_rng(0), n,
                                     prob.samples.astype(int))
    sim = HFLSimulator(sch, _loss, lenet.logreg_init(12, 4, device="cpu"),
                       [{k: train[k][ix] for k in train} for ix in parts],
                       lr=0.02, mode="async", mesh=mesh, device="cpu")
    sim.replay_departure(sim.cloud_vector(), np.ones(sim._hot_gids.size,
                                                     bool))
    return [sim.edge_mean_row(m).numpy().copy() for m in range(5)]


def _mesh_rank(meshes, setup):
    """One spawn's work: every mesh of its world size, async runs, the
    hook script and the streamed slabs."""
    torch.set_num_threads(1)
    test = setup[3]
    out = {}
    for d, m in meshes:
        mesh = make_agg_mesh(m, d, device="cpu", timeout=_timeout())
        runs = {}
        for s in STALENESS:
            sim = _sim(setup, mesh=mesh, max_staleness=s)
            with _Calls() as calls:
                res = sim.run(test, rounds=ROUNDS)
            runs[s] = dict(
                trace=_trace(res.timeline), times=res.times,
                test_acc=res.test_acc, test_loss=res.test_loss,
                train_loss=res.train_loss, final=_numpy(res.final_params),
                params=_numpy(sim.params), calls=calls.counts(),
                slab=tuple(sim._flat.shape), b=sim.schedule.b)
        sim = _sim(setup, mesh=mesh, max_staleness=2)
        out[d, m] = dict(runs=runs, hooks=_hooks(sim),
                         perm=sim._slayout.perm,
                         inv_perm=sim._slayout.inv_perm,
                         stream=_stream(mesh) if (d, m) in STREAM_MESHES
                         else None,
                         pad_first=_pad_first_rows(mesh) if (d, m) == (4, 1)
                         else None)
    return out


# ---------------------------------------------------------------------------
# Fixtures: the reference, the port on one device, the ranks.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    import jax

    from repro.models import lenet as j_lenet
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
def reference(setup):
    """The reference's single-device async run at each staleness bound."""
    import jax

    from repro.core import plan as j_plan
    from repro.core.problem import HFLProblem as JProblem
    from repro.fl.sim import HFLSimulator as JSim
    from repro.models import lenet as j_lenet
    prob_kw, init, ue_data, test = setup
    out = {}
    for s in STALENESS:
        jsim = JSim(j_plan(JProblem(**prob_kw)),
                    lambda p, b: j_lenet.logreg_loss(p, b, l2=1e-3), init,
                    ue_data, lr=0.02, mode="async", max_staleness=s)
        res = jsim.run(test, rounds=ROUNDS)
        out[s] = dict(trace=_trace(res.timeline), times=res.times,
                      test_acc=res.test_acc, test_loss=res.test_loss,
                      train_loss=res.train_loss,
                      final=[np.asarray(t) for t in
                             jax.tree.leaves(res.final_params)],
                      params=[np.asarray(t) for t in
                              jax.tree.leaves(jsim.params)])
    return out


@pytest.fixture(scope="module")
def single_hooks(setup):
    """The hook script on the port's single-device simulator."""
    return _hooks(_sim(setup, max_staleness=2))


@pytest.fixture(scope="module")
def rank_runs(setup):
    """{mesh: [each rank's result]}, one spawn per world size."""
    runs = {}
    for world in (1, 2, 4):
        meshes = [c for c in MESHES if c[0] * c[1] == world]
        per_rank = run_ranks(_mesh_rank, world, meshes, setup,
                             device="cpu", timeout_s=SPAWN_TIMEOUT_S)
        for c in meshes:
            runs[c] = [r[c] for r in per_rank]
    return runs


# ---------------------------------------------------------------------------
# Async on a mesh.
# ---------------------------------------------------------------------------


def _mesh_id(c):
    return "x".join(map(str, c))


@pytest.mark.parametrize("s", STALENESS)
@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_async_on_mesh_matches_reference_single_device(rank_runs, reference,
                                                       mesh, s):
    ref = reference[s]
    ranks = [r["runs"][s] for r in rank_runs[mesh]]
    first = ranks[0]
    assert first["trace"] == ref["trace"]
    np.testing.assert_array_equal(first["times"], ref["times"])
    for key in ("test_acc", "test_loss", "train_loss"):
        np.testing.assert_allclose(first[key], ref[key], rtol=0, atol=ATOL)
    for key in ("final", "params"):
        for a, b in zip(first[key], ref[key]):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    for r in ranks[1:]:                # the same SimResult on every rank
        assert r["trace"] == first["trace"]
        for key in ("times", "test_acc", "test_loss", "train_loss"):
            np.testing.assert_array_equal(r[key], first[key])
        for a, b in zip(r["final"] + r["params"],
                        first["final"] + first["params"]):
            np.testing.assert_array_equal(a, b)
    # each wave is b edge events on the rank's slab; the merges are plain
    # products, no cloud event
    waves = _waves(first["trace"])
    for r in ranks:
        assert r["calls"] == dict(segment_aggregate=r["b"] * waves,
                                  cloud_aggregate=0, weighted_mean=0,
                                  segment_sum=0)
        assert r["slab"][1] == 52 // mesh[1]


# ---------------------------------------------------------------------------
# The replay hooks on a mesh.
# ---------------------------------------------------------------------------


def _unpad_rows(x, r):
    """Padded rows (and padded columns) back to the original rows and
    ``F`` columns."""
    x = np.asarray(x)
    x = x[r["inv_perm"]]
    return x[:, :52] if x.ndim == 2 and x.shape[1] >= 52 else x


@pytest.mark.parametrize("hook", HOOKS)
@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_replay_hook_on_mesh_matches_single_device(rank_runs, single_hooks,
                                                   mesh, hook):
    ranks = rank_runs[mesh]
    got = ranks[0]["hooks"][hook]
    for r in ranks[1:]:                # every rank holds the global result
        other = r["hooks"][hook]
        if isinstance(got, list):
            for a, b in zip(other, got):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(other, got)
    want = single_hooks[hook]
    r0 = ranks[0]
    n_hot = r0["perm"].size
    if hook == "edge_mass":
        assert got == want
    elif hook in ("global_from_vector", "global_params", "params",
                  "params_setter"):
        for a, b in zip(got, want):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    elif hook == "hot_survivor_rows":
        assert got.shape == (SURVIVORS.shape[0], n_hot)
        np.testing.assert_array_equal(got[:, r0["inv_perm"]], want)
        pads = r0["perm"] < 0          # row-0 copies, as the buffer's pads
        np.testing.assert_array_equal(got[:, pads],
                                      np.repeat(want[:, :1], pads.sum(), 1))
    elif hook in ("cloud_vector", "edge_mean_row", "replay_merge"):
        assert got.shape[0] % mesh[1] == 0 and got.shape[0] >= 52
        assert (got[52:] == 0).all()   # pad columns stay 0
        np.testing.assert_allclose(got[:52], want, rtol=0, atol=ATOL)
    elif hook in ("device_rows", "hot_rows"):
        assert got.shape[0] == len(ROWS)
        np.testing.assert_allclose(got[:, :52], want, rtol=0, atol=ATOL)
    elif hook == "set_flat_state":
        # the state it was given, exactly, in the padded global layout
        np.testing.assert_array_equal(got, ranks[0]["hooks"]
                                      ["replay_departure"])
        np.testing.assert_allclose(_unpad_rows(got, r0), want, rtol=0,
                                   atol=ATOL)
    else:                              # padded global flat buffers
        assert got.shape[0] == n_hot
        np.testing.assert_allclose(_unpad_rows(got, r0), want, rtol=0,
                                   atol=ATOL)


def test_edge_mean_row_reads_a_member_row(rank_runs):
    want = _pad_first_rows()
    for r in rank_runs[4, 1]:
        for got, row in zip(r["pad_first"], want):
            assert np.abs(row).max() > 0
            np.testing.assert_allclose(got, row, rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# Streaming over the sharded buffer.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stream_reference():
    import jax.numpy as jnp

    from repro.fl import aggregate as j_agg
    x, w, gid = _stream_inputs()
    return np.asarray(j_agg.flat_edge_aggregate(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(gid), SM))


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("mesh", STREAM_MESHES, ids=_mesh_id)
def test_streaming_the_slab_matches_reference(rank_runs, stream_reference,
                                              mesh, chunk):
    ranks = [r["stream"] for r in rank_runs[mesh]]
    n_padded, f_padded = ranks[0]["shape"]
    padded = np.full((n_padded, f_padded), np.nan, np.float32)
    for r in ranks:
        c = r["chunks"][chunk]
        padded[r["rows"], r["cols"]] = c["out"]
        # one segment_sum call a chunk, on the rank's own rows
        n = c["n_local"]
        size = n if chunk == "n_local" else int(chunk)
        assert c["calls"]["segment_sum"] == -(-n // size)
    assert np.isfinite(padded).all()
    got = padded[ranks[0]["inv_perm"], :SF]
    np.testing.assert_allclose(got, stream_reference, rtol=0, atol=ATOL)
