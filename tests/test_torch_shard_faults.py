"""Faults and client sampling on a mesh of gloo ranks (CPU), sync and
async, against the JAX package's single-device simulator.

* ``HFLSimulator(fault_model=, fault_policy=, sampler=, mesh=)`` on the
  meshes (2,1) and (2,2), on the quickstart logreg problem with its
  schedule cut to a = 6, b = 3 (both packages: a tenth of the planned
  a* b* = 210 local steps a round, so a file of ranks takes under a
  minute), with the
  simulator's keys patched to the reference's inside each rank
  (``tests/_jax_key.py``): faulty sync under both policies, sampled sync,
  faults with sampling, faulty async, sampled async and faulty sampled
  async.  The clock (and the async trace) equal the reference's
  single-device run's, the losses and the model within 1e-5, every rank
  returns the same result; a sync round with a survivor is ``b`` edge
  events and one cloud event, an async wave ``b`` edge events.  (The
  reference's own mesh runs of these fail on the installed JAX, so its
  single-device run is the oracle.)
* A round in which one data shard's cohorts are all dead (injected
  ``faulty_cycle_stats``, as ``tests/test_torch_sim_faults.py``'s
  ``test_dead_edges_never_reach_the_cloud_event``): that shard adds an
  exact 0 (weight sum 0, numerator all 0, no NaN) to the cloud all-reduce,
  the model is finite and equals the single-device run's; on (2,1), (2,2)
  and (4,1) (two shards of padding only).
* A padded mesh draws the single-device cohort (the reference's, on its
  keys): the padded masks map back to it, and no pad row is ever sampled;
  fault survivors pad as row-0 copies.
"""
import dataclasses
import datetime
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import faults as t_f  # noqa: E402
from repro_torch.core import plan  # noqa: E402
from repro_torch.core.problem import HFLProblem  # noqa: E402
from repro_torch.fl import aggregate as t_agg  # noqa: E402
from repro_torch.fl import sampling as t_s  # noqa: E402
from repro_torch.fl.flatten import tree_leaves  # noqa: E402
from repro_torch.fl.sim import HFLSimulator  # noqa: E402
from repro_torch.kernels import hier_aggregate as ha  # noqa: E402
from repro_torch.launch.mesh import make_agg_mesh, run_ranks  # noqa: E402
from repro_torch.models import lenet  # noqa: E402

SPAWN_TIMEOUT_S = 150
ATOL = 1e-5
QUICKSTART = dict(num_edges=2, num_ues=8, epsilon=0.25, seed=0,
                  samples_lo=50, samples_hi=120)
MESHES = [(2, 1), (2, 2), (4, 1)]
CASE_MESHES = MESHES[:2]
CUT = dict(a=6, b=3)
ROUNDS = 4
SEEDS = dict(fault_seed=3, sample_seed=2)
CASES = [("sync", "wait_for_all"), ("sync", "deadline_failover"),
         ("sync", "sampler"), ("sync", "faults_x_sampler"),
         ("async", "deadline_failover"), ("async", "sampler"),
         ("async", "faults_x_sampler")]
COHORT_ROUNDS = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small operations gain nothing from more,
    and idle threads spinning would slow the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fault_model(f):
    return f.FaultModel(dropout=f.MarkovChurn(p_off=0.2, p_on=0.4),
                        loss=f.UplinkLoss(rate=0.3),
                        outage=f.EdgeOutage(rate=0.15, repair_cycles=2.0))


def _case(f, s, mode, case):
    """The simulator keywords of one case, in package ``f``/``s``."""
    kw = dict(mode=mode, max_staleness=1 if mode == "async" else 0, **SEEDS)
    if case in ("wait_for_all", "deadline_failover", "faults_x_sampler"):
        kw["fault_model"] = _fault_model(f)
        kw["fault_policy"] = (f.wait_for_all_policy()
                              if case == "wait_for_all"
                              else f.deadline_failover_policy())
    if case in ("sampler", "faults_x_sampler"):
        kw["sampler"] = s.make_sampler("weight", participation_rate=0.5)
    return kw


def _dead_stats(gids):
    """Round 0: edge 1 all dead, one UE of edge 0 alive; round 1: every
    UE dead; round 2: edge 0 down; round 3: every UE alive."""
    surv = np.ones((ROUNDS, gids.size), bool)
    surv[0] = False
    surv[0, np.flatnonzero(gids == 0)[0]] = True
    surv[1] = False
    down = np.zeros((ROUNDS, 2), bool)
    down[2, 0] = True
    return dict(cycle_times=np.full((ROUNDS, 2), 2.0), survivors=surv,
                delivered_frac=np.zeros((ROUNDS, 2)), windows=[], down=down,
                stall=np.zeros((ROUNDS, 2)))


def _timeout():
    return datetime.timedelta(seconds=SPAWN_TIMEOUT_S)


def _loss(p, b):
    return lenet.logreg_loss(p, b, l2=1e-3)


def _sim(setup, **kw):
    prob_kw, init, ue_data, _ = setup
    return HFLSimulator(dataclasses.replace(plan(HFLProblem(**prob_kw)),
                                            **CUT), _loss,
                        {k: torch.tensor(v) for k, v in init.items()},
                        ue_data, lr=0.02, device="cpu", **kw)


def _numpy(tree):
    return [t.detach().cpu().numpy().copy() for t in tree_leaves(tree)]


def _summary(res):
    return dict(times=res.times, test_acc=res.test_acc,
                test_loss=res.test_loss, train_loss=res.train_loss,
                final=_numpy(res.final_params),
                trace=(None if res.timeline is None else
                       [(k, dataclasses.astuple(e))
                        for k, e in res.timeline.trace]))


def _waves(trace):
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


def _cloud_partials():
    """Patches that record every cloud event's all-reduce operands
    (``num``, ``den``) on this rank."""
    got = []
    real_cloud = t_agg.flat_cloud_aggregate
    real_psum = t_agg.psum_weighted_mean

    def psum(num, den, group):
        got.append((num.clone().numpy(), float(den)))
        return real_psum(num, den, group)

    def cloud(buf, weights, **kw):
        with mock.patch.object(t_agg, "psum_weighted_mean", psum):
            return real_cloud(buf, weights, **kw)

    return got, mock.patch.object(t_agg, "flat_cloud_aggregate", cloud)


def _fault_rank(meshes, setup):
    """One spawn's work on the reference's keys: every case on every mesh
    of its world size, the dead shard's round and the cohort masks."""
    from _jax_key import JaxKey
    torch.set_num_threads(1)
    test = setup[3]
    keys = [mock.patch.object(HFLSimulator, name,
                              lambda self, attr=attr:
                              JaxKey(getattr(self, attr)))
            for name, attr in (("_delay_key", "delay_seed"),
                               ("_fault_key", "fault_seed"),
                               ("_sample_key", "sample_seed"))]
    for k in keys:
        k.start()
    out = {}
    try:
        for d, m in meshes:
            mesh = make_agg_mesh(m, d, device="cpu", timeout=_timeout())
            runs = {}
            for mode, case in (CASES if (d, m) in CASE_MESHES else ()):
                sim = _sim(setup, mesh=mesh, **_case(t_f, t_s, mode, case))
                with _Calls() as calls:
                    res = sim.run(test, rounds=ROUNDS)
                kept = (sim._sync_plan(ROUNDS)[1] if mode == "sync"
                        else None)
                runs[mode, case] = dict(_summary(res), calls=calls.counts(),
                                        b=sim.schedule.b, kept=kept)

            sim = _sim(setup, mesh=mesh,
                       fault_model=t_f.FaultModel(
                           dropout=t_f.BernoulliDropout(0.5)))
            fc = t_f.FaultyCycles(**_dead_stats(
                sim.group_ids.numpy()))
            partials, spy = _cloud_partials()
            with mock.patch.object(t_f, "faulty_cycle_stats",
                                   lambda *a, **k: fc), spy:
                dead = dict(_summary(sim.run(test, rounds=ROUNDS)),
                            partials=partials,
                            local_gids=sim._local_gids.numpy(),
                            local_weights=sim._local_weights.numpy())

            sampled = _sim(setup, mesh=mesh,
                           sampler=t_s.make_sampler("uniform", 0.5), **SEEDS)
            part = sampled._participation_matrix(COHORT_ROUNDS)
            out[d, m] = dict(
                runs=runs, dead=dead, part=part,
                part_hot=sampled._participation_hot(part),
                surv_hot=sampled.hot_survivor_rows(part),
                perm=sampled._slayout.perm)
    finally:
        for k in keys:
            k.stop()
    return out


# ---------------------------------------------------------------------------
# Fixtures.
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


def _jsim(setup, **kw):
    from repro.core import plan as j_plan
    from repro.core.problem import HFLProblem as JProblem
    from repro.fl.sim import HFLSimulator as JSim
    from repro.models import lenet as j_lenet
    prob_kw, init, ue_data, _ = setup
    return JSim(dataclasses.replace(j_plan(JProblem(**prob_kw)), **CUT),
                lambda p, b: j_lenet.logreg_loss(p, b, l2=1e-3), init,
                ue_data, lr=0.02, **kw)


def _j_summary(res):
    import jax
    return dict(times=res.times, test_acc=res.test_acc,
                test_loss=res.test_loss, train_loss=res.train_loss,
                final=[np.asarray(t) for t in
                       jax.tree.leaves(res.final_params)],
                trace=(None if res.timeline is None else
                       [(k, dataclasses.astuple(e))
                        for k, e in res.timeline.trace]))


@pytest.fixture(scope="module")
def reference(setup):
    """The reference's single-device run of every case, and of the dead
    shard's injected stats."""
    from repro.core import faults as j_f
    from repro.fl import sampling as j_s
    test = setup[3]
    out = {(mode, case): _j_summary(
        _jsim(setup, **_case(j_f, j_s, mode, case)).run(test, rounds=ROUNDS))
        for mode, case in CASES}
    gids = plan(HFLProblem(**QUICKSTART)).assoc.argmax(1)
    fc = j_f.FaultyCycles(**_dead_stats(gids))
    with mock.patch.object(j_f, "faulty_cycle_stats", lambda *a, **k: fc):
        out["dead"] = _j_summary(_jsim(setup, fault_model=j_f.FaultModel(
            dropout=j_f.BernoulliDropout(0.5))).run(test, rounds=ROUNDS))
    return out


@pytest.fixture(scope="module")
def rank_runs(setup):
    """{mesh: [each rank's result]}, one spawn per world size."""
    runs = {}
    for world in (2, 4):
        meshes = [c for c in MESHES if c[0] * c[1] == world]
        per_rank = run_ranks(_fault_rank, world, meshes, setup,
                             device="cpu", timeout_s=SPAWN_TIMEOUT_S)
        for c in meshes:
            runs[c] = [r[c] for r in per_rank]
    return runs


def _mesh_id(c):
    return "x".join(map(str, c))


def _assert_same_run(got, want):
    np.testing.assert_array_equal(got["times"], want["times"])
    assert got["trace"] == want["trace"]
    for key in ("test_acc", "test_loss", "train_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=ATOL)
    for a, b in zip(got["final"], want["final"]):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def _assert_ranks_agree(ranks):
    first = ranks[0]
    for r in ranks[1:]:
        assert r["trace"] == first["trace"]
        for key in ("times", "test_acc", "test_loss", "train_loss"):
            np.testing.assert_array_equal(r[key], first[key])
        for a, b in zip(r["final"], first["final"]):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Tests.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,case", CASES, ids=lambda c: str(c))
@pytest.mark.parametrize("mesh", CASE_MESHES, ids=_mesh_id)
def test_faults_and_sampling_on_mesh_match_reference(rank_runs, reference,
                                                     mesh, mode, case):
    ranks = [r["runs"][mode, case] for r in rank_runs[mesh]]
    _assert_same_run(ranks[0], reference[mode, case])
    _assert_ranks_agree(ranks)
    d = mesh[0]
    for r in ranks:
        if mode == "sync":
            k = int(r["kept"].any(axis=1).sum())
            want = dict(segment_aggregate=r["b"] * k,
                        cloud_aggregate=k * int(d == 1),
                        weighted_mean=k * int(d > 1))
        else:
            want = dict(segment_aggregate=r["b"] * _waves(r["trace"]),
                        cloud_aggregate=0, weighted_mean=0)
        assert r["calls"] == want


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_dead_shard_adds_an_exact_zero(rank_runs, reference, mesh):
    ranks = [r["dead"] for r in rank_runs[mesh]]
    _assert_same_run(ranks[0], reference["dead"])
    _assert_ranks_agree(ranks)
    assert ranks[0]["test_loss"][1] == ranks[0]["test_loss"][0]
    # round 1 (all dead) has no cloud event; in round 0 the shard that
    # holds edge 1 (or only padding) sends weight 0 and an all-zero sum
    for r in ranks:
        assert len(r["partials"]) == 3
        num, den = r["partials"][0]
        assert np.isfinite(num).all()
        live = ((r["local_weights"] > 0) & (r["local_gids"] == 0)).any()
        if live:
            assert den > 0
        else:
            assert den == 0.0 and (num == 0).all()
    assert any(r["partials"][0][1] == 0.0 for r in ranks)


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_padded_mesh_draws_the_single_device_cohort(rank_runs, setup, mesh):
    """The ranks drew on the reference's keys: their cohorts are the
    reference's single-device ones."""
    from repro.fl import sampling as j_s
    jsim = _jsim(setup, sampler=j_s.make_sampler("uniform", 0.5), **SEEDS)
    want = jsim._participation_matrix(COHORT_ROUNDS)
    first = rank_runs[mesh][0]
    for r in rank_runs[mesh]:
        np.testing.assert_array_equal(r["part"], want)
        np.testing.assert_array_equal(r["part_hot"], first["part_hot"])
    perm = first["perm"]
    pads = perm < 0
    hot = first["part_hot"]
    assert hot.shape == (COHORT_ROUNDS, perm.size)
    np.testing.assert_array_equal(hot[:, ~pads], want[:, perm[~pads]])
    assert not hot[:, pads].any()           # a pad row is never sampled
    # survivors pad as row-0 copies (weight 0 wherever it matters)
    surv = first["surv_hot"]
    np.testing.assert_array_equal(surv[:, ~pads], want[:, perm[~pads]])
    np.testing.assert_array_equal(
        surv[:, pads], np.repeat(want[:, :1], pads.sum(), axis=1))
