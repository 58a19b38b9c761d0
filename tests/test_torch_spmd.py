"""The port's SPMD backend (``repro_torch.fl.spmd``) on ('edge', 'ue')
meshes of gloo ranks (CPU), against the JAX package.

* ``make_hfl_cloud_round`` with ``make_fl_mesh(E, U)``, one UE a rank, gd
  and DANE, on ``tests/test_fl_spmd.py``'s logreg problem: every rank's
  model after the cloud round within 1e-5 of the reference's stacked
  loop (``clients.gd_local_steps`` or ``dane_local_steps`` with the global
  gradient, then ``stacked_weighted_average`` per edge ``b`` times and over
  the fleet once), on the meshes (1,1), (1,2), (2,1) and (2,2).  (The
  reference's own ``make_hfl_cloud_round`` needs several JAX devices,
  which this test process does not have; its test holds it to the same
  loop.)  No kernel wrapper is called on the ranks.
* The port's single-device stacked loop, which ``chip_smoke.py`` holds
  the SPMD round to on the card, equals the reference's loop within 1e-5.
* ``make_fl_mesh``'s coordinates and checks, ``stack_for_mesh``,
  ``hfl_spmd_round``, and ``make_local_sgd_train_step``'s check of its
  ``sync`` argument.

The ranks run the module-level ``_*rank`` functions, one spawn per world
size, each with its own timeout; JAX is imported only inside the tests.
"""
import datetime
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.fl import clients as t_clients  # noqa: E402
from repro_torch.fl import spmd  # noqa: E402
from repro_torch.fl.aggregate import stacked_weighted_average  # noqa: E402
from repro_torch.fl.flatten import tree_leaves  # noqa: E402
from repro_torch.kernels import hier_aggregate as ha  # noqa: E402
from repro_torch.launch.mesh import make_fl_mesh, run_ranks  # noqa: E402
from repro_torch.models import lenet  # noqa: E402

SPAWN_TIMEOUT_S = 120
ATOL = 1e-5
FL_MESHES = [(1, 1), (1, 2), (2, 1), (2, 2)]
SOLVERS = ("gd", "dane")
A, B, LR, MU = 4, 2, 0.02, 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _timeout():
    return datetime.timedelta(seconds=SPAWN_TIMEOUT_S)


def _loss(p, b):
    return lenet.logreg_loss(p, b, l2=1e-3)


def _problem(e, u):
    """``tests/test_fl_spmd.py``'s inputs for an E x U fleet: stacked
    numpy batches and weights 1..E*U."""
    from repro_torch.data import partition, synthetic
    train = synthetic.logreg_data(seed=0, n=800, dim=16, num_classes=4)
    parts = partition.iid_partition(np.random.default_rng(0), 800, e * u)
    batches = {k: np.stack([train[k][ix] for ix in parts]) for k in train}
    return batches, np.arange(1.0, e * u + 1.0, dtype=np.float32)


def _spmd_rank(meshes, init):
    torch.set_num_threads(1)
    out = {}
    for e, u in meshes:
        mesh = make_fl_mesh(e, u, device="cpu", timeout=_timeout())
        batches, weights = _problem(e, u)
        params = spmd.stack_for_mesh(
            {k: torch.tensor(v) for k, v in init.items()}, e, u)
        for solver in SOLVERS:
            fn = spmd.make_hfl_cloud_round(_loss, mesh, a=A, b=B, lr=LR,
                                           solver=solver, dane_mu=MU)
            before = dict(ha.launch_counts)
            with mock.patch.object(ha, "segment_aggregate") as k1, \
                    mock.patch.object(ha, "cloud_aggregate") as k2:
                got = fn(mesh.local(params), mesh.local(batches),
                         mesh.local(weights))
            out[e, u, solver] = dict(
                params=[t.numpy().copy() for t in tree_leaves(got)],
                kernels=k1.call_count + k2.call_count,
                launched=ha.launch_counts != before)
        out[e, u, "coords"] = (mesh.rank, mesh.edge_index, mesh.ue_index,
                               mesh.shape, mesh.size)
        out[e, u, "wrapper"] = [t.numpy().copy() for t in tree_leaves(
            spmd.hfl_spmd_round(_loss, mesh, mesh.local(params),
                                mesh.local(batches), mesh.local(weights),
                                a=A, b=B, lr=LR))]
    errors = []
    try:
        make_fl_mesh(3, 1, device="cpu")
    except ValueError as err:
        errors.append(str(err))
    out["errors"] = errors
    return out


@pytest.fixture(scope="module")
def init():
    import jax

    from repro.models import lenet as j_lenet
    return jax.tree.map(np.asarray,
                        j_lenet.logreg_init(jax.random.PRNGKey(0), 16, 4))


def _reference_loop(init, e, u, solver):
    """The reference's stacked loop (``tests/test_fl_spmd.py``'s body; for
    DANE the global gradient before each edge round)."""
    import jax
    import jax.numpy as jnp

    from repro.fl import aggregate, clients
    batches, weights = _problem(e, u)
    batches = {k: jnp.asarray(v) for k, v in batches.items()}
    weights = jnp.asarray(weights)
    gid = jnp.repeat(jnp.arange(e), u)
    p = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (e * u,) + x.shape),
                     init)
    gd = clients.gd_local_steps(_j_loss, A, LR)
    dane = clients.dane_local_steps(_j_loss, A, LR, mu_prox=MU)
    for _ in range(B):
        if solver == "dane":
            g_bar = clients.global_gradient(_j_loss, p, batches, weights)
            p = jax.vmap(lambda q, bb: dane(q, bb, g_bar))(p, batches)
        else:
            p = jax.vmap(gd)(p, batches)
        p = aggregate.stacked_weighted_average(p, weights, group_ids=gid,
                                               num_groups=e)
    p = aggregate.stacked_weighted_average(p, weights)
    return [np.asarray(t) for t in jax.tree.leaves(p)]


def _j_loss(p, b):
    from repro.models import lenet as j_lenet
    return j_lenet.logreg_loss(p, b, l2=1e-3)


@pytest.fixture(scope="module")
def reference(init):
    return {(e, u, s): _reference_loop(init, e, u, s)
            for e, u in FL_MESHES for s in SOLVERS}


@pytest.fixture(scope="module")
def rank_runs(init):
    runs = {}
    for world in (1, 2, 4):
        meshes = [c for c in FL_MESHES if c[0] * c[1] == world]
        per_rank = run_ranks(_spmd_rank, world, meshes, init, device="cpu",
                             timeout_s=SPAWN_TIMEOUT_S)
        for c in meshes:
            for key in SOLVERS + ("coords", "wrapper"):
                runs[c + (key,)] = [r[c + (key,)] for r in per_rank]
        runs["errors", world] = [r["errors"] for r in per_rank]
    return runs


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("e,u", FL_MESHES)
def test_cloud_round_matches_reference_stacked_loop(rank_runs, reference,
                                                    e, u, solver):
    want = reference[e, u, solver]
    ranks = rank_runs[e, u, solver]
    assert len(ranks) == e * u
    for r, got in enumerate(ranks):
        for a, b in zip(got["params"], want):
            assert a.shape == (1,) + b.shape[1:]
            np.testing.assert_allclose(a[0], b[r], rtol=0, atol=ATOL)
        # no kernel wrapper on the ranks: eq. 6 and 10 are all-reduces
        assert got["kernels"] == 0 and not got["launched"]
    for got in ranks[1:]:            # one cloud model on every rank
        for a, b in zip(got["params"], ranks[0]["params"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("e,u", FL_MESHES)
def test_fl_mesh_coordinates_and_wrapper(rank_runs, e, u):
    coords = rank_runs[e, u, "coords"]
    assert coords == [(r, r // u, r % u, {"edge": e, "ue": u}, e * u)
                      for r in range(e * u)]
    for got in rank_runs[e, u, "wrapper"]:
        for a, b in zip(got, rank_runs[e, u, "gd"][0]["params"]):
            np.testing.assert_array_equal(a, b)


def test_make_fl_mesh_needs_a_process_group_of_its_size(rank_runs):
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_fl_mesh(1, 1, device="cpu")
    for world in (1, 2, 4):
        assert all(f"needs 3 ranks, the process group has {world}" in e[0]
                   for e in rank_runs["errors", world])


@pytest.mark.parametrize("solver", SOLVERS)
def test_port_stacked_loop_matches_reference(init, reference, solver):
    """The port's single-device loop (``gd_local_steps`` or
    ``dane_local_steps`` + ``stacked_weighted_average``: K1 and K2's
    wrappers), the card reference of ``chip_smoke.py``'s SPMD check."""
    e, u = 2, 2
    batches, weights = _problem(e, u)
    batches = {k: torch.from_numpy(v) for k, v in batches.items()}
    w = torch.from_numpy(weights)
    gid = torch.arange(e).repeat_interleave(u)
    p = {k: v.clone() for k, v in spmd.stack_for_mesh(
        {k: torch.tensor(v) for k, v in init.items()}, e, u).items()}
    gd = t_clients.gd_local_steps(_loss, A, LR)
    dane = t_clients.dane_local_steps(_loss, A, LR, mu_prox=MU)
    for _ in range(B):
        if solver == "dane":
            dane(p, batches, t_clients.global_gradient(_loss, p, batches, w))
        else:
            gd(p, batches)
        p = {k: v.clone() for k, v in stacked_weighted_average(
            p, w, group_ids=gid, num_groups=e).items()}
    p = stacked_weighted_average(p, w)
    for a, b in zip(tree_leaves(p), reference[e, u, solver]):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=ATOL)


def test_stack_for_mesh_and_unported_train_step():
    """``stack_for_mesh`` over dicts and lists; the local-SGD train step,
    ported with the transformer's training half (its mesh runs:
    ``tests/test_torch_train_spmd.py``), rejects an unknown sync before
    it computes anything."""
    params = {"w": torch.ones(3, 2), "b": {"c": torch.zeros(2)},
              "layers": [{"d": torch.ones(4)}]}
    stacked = spmd.stack_for_mesh(params, 2, 3)
    assert stacked["w"].shape == (6, 3, 2)
    assert stacked["b"]["c"].shape == (6, 2)
    assert stacked["layers"][0]["d"].shape == (6, 4)
    step = spmd.make_local_sgd_train_step(None, None, mesh=mock.Mock(
        shape={"data": 2, "model": 1}), a=2, b=2)
    with pytest.raises(ValueError, match="sync"):
        step({}, (), {}, "pod")
    with pytest.raises(ValueError, match="solver"):
        spmd.make_hfl_cloud_round(_loss, None, a=1, b=1, lr=0.1,
                                  solver="adam")
