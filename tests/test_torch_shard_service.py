"""The always-on service (``repro_torch.launch.service.HFLService``) over a
mesh of gloo ranks (CPU), against the port's single-device service, which
``tests/test_torch_service.py`` holds to the reference.

* On the meshes (2,1), (1,2) and (4,1) (pad rows in UE 0's edge id),
  ``_service_pair.CHEAP``'s federation (12 UEs, 3 edges, a* = 3, b* = 4),
  ``tests/test_torch_service.py``'s burst segments with the degraded
  mode's UE shedding from a backlog of 2: the plain service, the
  streaming merge
  (``merge_stream_chunk=3``: ``segment_sum`` once a chunk on every rank)
  and an ``edge_outage`` service.  The trace equals the single-device
  service's record for record, the published model ``g`` within 1e-6
  (``tests/test_chaos.py``'s rule), every rank's the same.
* A checkpoint mid-run and a resume on fresh mesh services: only rank 0
  writes (``save_pytree`` called there alone), every rank reads, and the
  resumed run ends with the uninterrupted mesh run's trace and ``g``
  (within 1e-6).

The ranks run the module-level ``_service_rank`` (one spawn per world
size, each with a timeout); the reference is not imported here.
"""
import datetime
import os
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _service_pair as sp  # noqa: E402

from repro_torch.core import scenario  # noqa: E402
from repro_torch.kernels import hier_aggregate as ha  # noqa: E402
from repro_torch.launch import service as ts  # noqa: E402
from repro_torch.launch.mesh import make_agg_mesh, run_ranks  # noqa: E402

SPAWN_TIMEOUT_S = 150
G_TOL = 1e-6
MESHES = [(2, 1), (1, 2), (4, 1)]
BURST = [("iid_campus", 1.0, 15.0), ("iid_campus", 4.0, 15.0),
         ("iid_campus", 1.0, float("inf"))]
EVENTS = 40
CKPT_EVERY, STOP = 10, 20
CHUNK = 3
# a backlog of 2 degrades the service, which then sheds half of each
# departing cohort (its lightest members)
SHED = dict(backlog_high=1, backlog_low=0, ue_shed_frac=0.5)
CONFIGS = {"plain": {}, "stream": dict(merge_stream_chunk=CHUNK),
           "edge_outage": dict(fault_model=scenario("edge_outage").faults,
                               fault_seed=0)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _svc(mesh=None, **kw):
    cfg = ts.ServiceConfig(segments=sp.segments(ts, BURST),
                           max_staleness=sp.S_MAX, **SHED, **kw)
    return ts.HFLService(sp.tsim(mesh=mesh, **sp.CHEAP), cfg)


def _count_rows(svc):
    """Record the edge of every merge row ``svc`` reads (at each arrival,
    a job shed later included) into the returned list."""
    edges, read = [], svc._merge_row

    def counted(m):
        edges.append(m)
        return read(m)

    svc._merge_row = counted
    return edges


def _chunks(svc, edges):
    """``segment_sum`` calls the streamed merge rows need: one a chunk of
    each cohort's members (a mesh's pad rows are in no cohort)."""
    sizes = np.bincount(svc._gids[svc._w > 0])
    return sum(-(-int(sizes[m]) // CHUNK) for m in edges)


def _service_rank(meshes, ckpt_root):
    import torch.distributed as dist
    torch.set_num_threads(1)
    timeout = datetime.timedelta(seconds=SPAWN_TIMEOUT_S)
    out = {}
    for d, m in meshes:
        mesh = make_agg_mesh(m, d, device="cpu", timeout=timeout)
        for name, kw in CONFIGS.items():
            with mock.patch.object(ha, "segment_sum",
                                   wraps=ha.segment_sum) as k4:
                svc = _svc(mesh, **kw)
                edges = _count_rows(svc)
                svc.run(EVENTS)
            out[d, m, name] = dict(trace=svc.trace, g=svc.g,
                                   k4=k4.call_count,
                                   chunks=_chunks(svc, edges))
        ckpt = dict(ckpt_dir=os.path.join(ckpt_root, f"{d}x{m}"),
                    ckpt_every=CKPT_EVERY)
        with mock.patch.object(ts, "save_pytree",
                               wraps=ts.save_pytree) as saves:
            full = _svc(mesh, **ckpt)
            full.run(EVENTS)
            victim = _svc(mesh, **dict(ckpt, ckpt_dir=ckpt["ckpt_dir"] +
                                       "-victim"))
            victim.run(STOP)
        dist.barrier()
        resumed = _svc(mesh, **dict(ckpt, ckpt_dir=ckpt["ckpt_dir"] +
                                    "-victim"))
        src = resumed.restore_latest()
        at = resumed.events_done
        resumed.run(EVENTS)
        out[d, m, "resume"] = dict(full=full.trace, full_g=full.g,
                                   trace=resumed.trace, g=resumed.g,
                                   src=os.path.basename(src), at=at,
                                   saves=saves.call_count)
    return out


@pytest.fixture(scope="module")
def single():
    """The port's single-device services."""
    out = {}
    for name, kw in CONFIGS.items():
        svc = _svc(**kw)
        svc.run(EVENTS)
        out[name] = dict(trace=svc.trace, g=svc.g)
    return out


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_service"))
    runs = {}
    for world in (2, 4):
        meshes = [c for c in MESHES if c[0] * c[1] == world]
        per_rank = run_ranks(_service_rank, world, meshes, root,
                             device="cpu", timeout_s=SPAWN_TIMEOUT_S)
        runs.update({k: [r[k] for r in per_rank] for k in per_rank[0]})
    return runs


def _mesh_id(c):
    return "x".join(map(str, c))


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_mesh_service_matches_single_device(rank_runs, single, mesh, name):
    ranks = rank_runs[mesh + (name,)]
    want = single[name]
    sp.assert_same_trace(ranks[0]["trace"], want["trace"])
    assert ranks[0]["g"].shape == want["g"].shape
    assert float(np.abs(ranks[0]["g"] - want["g"]).max()) <= G_TOL
    for r in ranks[1:]:
        sp.assert_same_trace(r["trace"], ranks[0]["trace"], rtol=0)
        np.testing.assert_array_equal(r["g"], ranks[0]["g"])
    kinds = {r["kind"] for r in ranks[0]["trace"]}
    assert "degraded" in kinds             # the burst sheds
    if name == "edge_outage":
        assert {"fail", "repair"} <= kinds
    for r in ranks:        # each rank folds the gathered rows, chunk by chunk
        assert r["k4"] == (r["chunks"] if name == "stream" else 0)
        if name == "stream":
            assert r["k4"] > 0


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_mesh_checkpoint_and_resume(rank_runs, mesh):
    ranks = rank_runs[mesh + ("resume",)]
    # rank 0 wrote every checkpoint: the full run's 4, the victim's 2
    assert [r["saves"] for r in ranks] == [EVENTS // CKPT_EVERY +
                                          STOP // CKPT_EVERY] + \
        [0] * (len(ranks) - 1)
    for r in ranks:
        assert r["src"] == f"ckpt-{STOP // CKPT_EVERY}.npz"
        assert r["at"] == STOP
        assert _merges(r["trace"]) == _merges(r["full"])
        assert any(x["kind"] == "resume" for x in r["trace"])
        assert float(np.abs(r["g"] - r["full_g"]).max()) <= G_TOL
    np.testing.assert_array_equal(ranks[1]["g"], ranks[0]["g"])


def _merges(trace):
    return [r for r in trace if r["kind"] == "merge"]
