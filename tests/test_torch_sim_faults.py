"""The port's fault and sampled simulator paths
(``HFLSimulator(fault_model=, fault_policy=, fault_seed=, sampler=,
sample_seed=)``, ``replay_departure(ue_ok=, agg_weights=)``) against the
JAX package's ``repro.fl.sim.HFLSimulator``.

* With the simulator's keys patched to the reference's (``JaxKey`` over
  ``jax.random.PRNGKey(seed)``, the key the reference makes of each
  seed), the clock and the async trace are equal and the losses and
  params within 1e-5 (logreg), sync and async, under both fault
  policies, a sampler, and faults x sampler; a SMOKE-width LeNet faulty
  round within 1e-4 of its largest parameter.
* A null fault model and a rate-1 sampler route to the legacy paths: the
  clock, losses and params are byte-identical to a run without them.
* Hazards: a round with every edge but one dead and a round with every
  edge dead give a finite model, and no cloud event ever sees an
  all-zero weight vector (the port's K2 gives NaN for one); the dead
  cohort's weights are exact zeros.
* The port's own draws are keyed by ``fault_seed`` and ``sample_seed``.
"""
import dataclasses
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _jax_key import JaxKey  # noqa: E402

from repro.configs.lenet_mnist import SMOKE_CONFIG as J_SMOKE  # noqa: E402
from repro.core import faults as j_f  # noqa: E402
from repro.core import plan as j_plan  # noqa: E402
from repro.core.problem import HFLProblem as JProblem  # noqa: E402
from repro.fl import sampling as j_s  # noqa: E402
from repro.fl import sim as j_sim  # noqa: E402
from repro.models import lenet as j_lenet  # noqa: E402
from repro_torch.core import faults as t_f  # noqa: E402
from repro_torch.core import plan as t_plan  # noqa: E402
from repro_torch.core.problem import HFLProblem as TProblem  # noqa: E402
from repro_torch.core.stochastic import Key  # noqa: E402
from repro_torch.data import partition, synthetic  # noqa: E402
from repro_torch.fl import aggregate as t_agg  # noqa: E402
from repro_torch.fl import sampling as t_s  # noqa: E402
from repro_torch.fl import sim as t_sim  # noqa: E402
from repro_torch.fl.flatten import tree_leaves  # noqa: E402
from repro_torch.models import lenet as t_lenet  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

PROBLEM = dict(num_edges=2, num_ues=8, epsilon=0.25, seed=0,
               samples_lo=50, samples_hi=120)
ATOL = 1e-5
ROUNDS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small operations gain nothing from more,
    and idle threads spinning would slow the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j_loss(p, b):
    return j_lenet.logreg_loss(p, b, l2=1e-3)


def _t_loss(p, b):
    return t_lenet.logreg_loss(p, b, l2=1e-3)


@pytest.fixture(scope="module")
def logreg():
    """``tests/test_torch_stochastic.py``'s logreg setup, for both
    packages."""
    jsch = j_plan(JProblem(**PROBLEM))
    tsch = t_plan(TProblem(**PROBLEM))
    train = synthetic.logreg_data(seed=0, n=800, dim=12, num_classes=4)
    test = synthetic.logreg_data(seed=1, n=200, dim=12, num_classes=4)
    parts = partition.size_partition(np.random.default_rng(0), 800,
                                     tsch.problem.samples.astype(int))
    ue_data = [{k: train[k][ix] for k in train} for ix in parts]
    init = jax.tree.map(np.asarray,
                        j_lenet.logreg_init(jax.random.PRNGKey(0), 12, 4))
    return jsch, tsch, init, ue_data, test


@pytest.fixture
def jax_keys():
    """The port's simulator draws with the reference's keys."""
    seeds = {"_delay_key": "delay_seed", "_fault_key": "fault_seed",
             "_sample_key": "sample_seed"}
    patches = [mock.patch.object(
        t_sim.HFLSimulator, name,
        lambda self, attr=attr: JaxKey(getattr(self, attr)))
        for name, attr in seeds.items()]
    for p in patches:
        p.start()
    yield
    for p in patches:
        p.stop()


def _tsim(setup, **kw):
    _, tsch, init, ue_data, _ = setup
    return t_sim.HFLSimulator(tsch, _t_loss,
                              from_jax_params(init, device="cpu"), ue_data,
                              lr=0.02, device="cpu", **kw)


def _jsim(setup, **kw):
    jsch, _, init, ue_data, _ = setup
    return j_sim.HFLSimulator(jsch, _j_loss, init, ue_data, lr=0.02, **kw)


def _leaves(params):
    if isinstance(next(iter(params.values())), torch.Tensor):
        return [x.numpy() for x in tree_leaves(params)]
    return [np.asarray(x) for x in jax.tree.leaves(params)]


def _plain(trace):
    return [(k, dataclasses.astuple(e)) for k, e in trace]


def _fault_model(f):
    return f.FaultModel(dropout=f.MarkovChurn(p_off=0.2, p_on=0.4),
                        loss=f.UplinkLoss(rate=0.3),
                        outage=f.EdgeOutage(rate=0.15, repair_cycles=2.0))


def _case(f, s, case):
    kw = {}
    if case in ("wait_for_all", "deadline_failover", "faults_x_sampler"):
        kw["fault_model"] = _fault_model(f)
        kw["fault_policy"] = (f.wait_for_all_policy()
                              if case == "wait_for_all"
                              else f.deadline_failover_policy())
    if case in ("sampler", "faults_x_sampler"):
        kw["sampler"] = s.make_sampler("weight", participation_rate=0.5)
    return kw


CASES = ["wait_for_all", "deadline_failover", "sampler", "faults_x_sampler"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", ["sync", "async"])
def test_run_matches_reference_on_its_keys(logreg, jax_keys, mode, case):
    test = logreg[4]
    kw = dict(mode=mode, max_staleness=1 if mode == "async" else 0,
              fault_seed=3, sample_seed=2)
    jres = _jsim(logreg, **kw, **_case(j_f, j_s, case)).run(test,
                                                            rounds=ROUNDS)
    tres = _tsim(logreg, **kw, **_case(t_f, t_s, case)).run(test,
                                                            rounds=ROUNDS)
    np.testing.assert_array_equal(tres.times, jres.times)
    if mode == "async":
        assert _plain(tres.timeline.trace) == _plain(jres.timeline.trace)
    for name in ("test_acc", "test_loss", "train_loss"):
        np.testing.assert_allclose(getattr(tres, name), getattr(jres, name),
                                   atol=ATOL)
    for t, j in zip(_leaves(tres.final_params), _leaves(jres.final_params)):
        np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)
        assert np.isfinite(t).all()


def test_lenet_faulty_round_matches_reference(jax_keys):
    """SMOKE-width LeNet, a=5, b=3, one faulty sync round with a sampled
    cohort: params within 1e-4 of their largest magnitude."""
    jsch = dataclasses.replace(j_plan(JProblem(**PROBLEM)), a=5, b=3)
    tsch = dataclasses.replace(t_plan(TProblem(**PROBLEM)), a=5, b=3)
    train, test = synthetic.synthetic_mnist(seed=0, n_train=400, n_test=64)
    parts = partition.size_partition(np.random.default_rng(0), 400,
                                     tsch.problem.samples.astype(int))
    ue_data = [{k: train[k][ix] for k in train} for ix in parts]
    init = jax.tree.map(np.asarray, jax.jit(
        lambda k: j_lenet.lenet_init(k, J_SMOKE))(jax.random.PRNGKey(0)))
    kw = dict(lr=0.05, samples_per_ue=8, fault_seed=1, sample_seed=1)
    jfm = j_f.FaultModel(dropout=j_f.BernoulliDropout(0.3),
                         loss=j_f.UplinkLoss(0.25))
    tfm = t_f.FaultModel(dropout=t_f.BernoulliDropout(0.3),
                         loss=t_f.UplinkLoss(0.25))
    jres = j_sim.HFLSimulator(
        jsch, j_lenet.lenet_loss, init, ue_data, fault_model=jfm,
        sampler=j_s.make_sampler("uniform", 0.6), **kw).run(test, rounds=1)
    tres = t_sim.HFLSimulator(
        tsch, t_lenet.lenet_loss, from_jax_params(init, device="cpu"),
        ue_data, device="cpu", fault_model=tfm,
        sampler=t_s.make_sampler("uniform", 0.6), **kw).run(test, rounds=1)
    np.testing.assert_array_equal(tres.times, jres.times)
    jp, tp = _leaves(jres.final_params), _leaves(tres.final_params)
    scale = max(float(np.abs(x).max()) for x in jp)
    assert max(float(np.abs(t - j).max()) for t, j in zip(tp, jp)) <= \
        1e-4 * scale


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_null_routing_is_byte_identical(logreg, mode):
    test = logreg[4]
    kw = dict(mode=mode, max_staleness=1 if mode == "async" else 0)
    base = _tsim(logreg, **kw).run(test, rounds=3)
    for extra in (dict(fault_model=t_f.FaultModel(), fault_seed=7),
                  dict(fault_model=t_f.FaultModel(
                      dropout=t_f.BernoulliDropout(0.0),
                      loss=t_f.UplinkLoss(0.0))),
                  dict(sampler=t_s.UniformSampler(participation_rate=1.0),
                       sample_seed=5),
                  dict(sampler=t_s.make_sampler("pareto", 1.0),
                       fault_model=t_f.FaultModel())):
        sim = _tsim(logreg, **kw, **extra)
        assert sim.fault_model is None and sim.sampler is None
        res = sim.run(test, rounds=3)
        assert base.times.tobytes() == res.times.tobytes()
        for name in ("test_acc", "test_loss", "train_loss"):
            assert getattr(base, name).tobytes() == \
                getattr(res, name).tobytes()
        for a, b in zip(_leaves(base.final_params),
                        _leaves(res.final_params)):
            assert a.tobytes() == b.tobytes()


def _injected(fc):
    """A ``faulty_cycle_stats`` stand-in returning ``fc`` (both packages'
    simulators call it through their ``faults`` module)."""
    return lambda *a, **k: fc


def test_dead_edges_never_reach_the_cloud_event(logreg):
    """Round 0 keeps one UE of edge 0 and kills edge 1; round 1 kills
    every UE; round 2 kills edge 0 by an outage; round 3 keeps all.  The
    port equals the reference on these stats, the all-dead round leaves
    the model where it was, the partly dead rounds give finite params,
    and every cloud event's weights are nonzero (K2 never sees an
    all-zero vector)."""
    jsch, tsch, _, _, test = logreg
    gids = tsch.assoc.argmax(1)
    surv = np.ones((ROUNDS, 8), bool)
    surv[0] = False
    surv[0, np.flatnonzero(gids == 0)[0]] = True
    surv[1] = False
    down = np.zeros((ROUNDS, 2), bool)
    down[2, 0] = True
    fc = dict(cycle_times=np.full((ROUNDS, 2), 2.0), survivors=surv,
              delivered_frac=np.zeros((ROUNDS, 2)), windows=[], down=down,
              stall=np.zeros((ROUNDS, 2)))
    clouds = []
    real = t_agg.flat_cloud_aggregate

    def spy(buf, weights, **kw):
        clouds.append(torch.as_tensor(weights).clone())
        return real(buf, weights, **kw)

    with mock.patch.object(t_f, "faulty_cycle_stats",
                           _injected(t_f.FaultyCycles(**fc))), \
            mock.patch.object(j_f, "faulty_cycle_stats",
                              _injected(j_f.FaultyCycles(**fc))), \
            mock.patch.object(t_agg, "flat_cloud_aggregate", spy):
        tres = _tsim(logreg, fault_model=t_f.FaultModel(
            dropout=t_f.BernoulliDropout(0.5))).run(test, rounds=ROUNDS)
        jres = _jsim(logreg, fault_model=j_f.FaultModel(
            dropout=j_f.BernoulliDropout(0.5))).run(test, rounds=ROUNDS)
    assert len(clouds) == 3                     # round 1 was skipped
    for w in clouds:
        assert float(w.sum()) > 0 and torch.isfinite(w).all()
    assert (clouds[0][torch.as_tensor(gids == 1)] == 0).all()
    assert (clouds[1][torch.as_tensor(gids == 0)] == 0).all()
    assert tres.test_loss[1] == tres.test_loss[0]   # the model stayed put
    np.testing.assert_array_equal(tres.times, jres.times)
    np.testing.assert_allclose(tres.test_loss, jres.test_loss, atol=ATOL)
    for t, j in zip(_leaves(tres.final_params), _leaves(jres.final_params)):
        assert np.isfinite(t).all()
        np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)


def test_round_weights_and_replay_departure_match_reference(logreg):
    """``_fault_round_weights`` (a dead cohort's edge weights exactly 0,
    its cloud weights 0) and one async wave under ``ue_ok=`` and
    ``agg_weights=``, against the reference's."""
    gids = logreg[1].assoc.argmax(1)
    ok = np.ones(8, bool)
    ok[gids == 1] = False
    ok[np.flatnonzero(gids == 0)[:2]] = False
    jsim, tsim = (_jsim(logreg, mode="async", max_staleness=1),
                  _tsim(logreg, mode="async", max_staleness=1))
    tw, tc = tsim._fault_round_weights(ok)
    jw, jc = jsim._fault_round_weights(ok)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert (tw[torch.as_tensor(~ok)] == 0).all()
    assert (tc[torch.as_tensor(gids == 1)] == 0).all()
    base = np.linspace(0.5, 2.0, 8)
    tw, _ = tsim._fault_round_weights(ok, base=base)
    jw, _ = jsim._fault_round_weights(ok, base=base)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)

    mask = gids == 0
    for kw in (dict(ue_ok=ok), dict(ue_ok=ok, agg_weights=base)):
        jg, tg = jsim.cloud_vector(), tsim.cloud_vector()
        jsim.replay_departure(jg, mask, **kw)
        tsim.replay_departure(tg, mask, **kw)
        np.testing.assert_allclose(tsim.flat_state(), jsim.flat_state(),
                                   atol=ATOL)
        # the rows of the edge not departing did not move
        np.testing.assert_array_equal(tsim.flat_state()[~mask],
                                      np.asarray(jsim.flat_state())[~mask])


def test_own_draws_keyed_by_fault_and_sample_seeds(logreg):
    """Same seeds, the same run; another fault seed another clock; the
    sync clock is the policy's round times of ``faulty_cycle_stats``
    under ``Key(fault_seed)``, and the sampled clock the cohort-masked
    deterministic cycles of ``Key(sample_seed)``'s masks."""
    from repro_torch.core import DeterministicDelays
    _, tsch, _, _, test = logreg
    fm = _fault_model(t_f)
    runs = [_tsim(logreg, fault_model=fm, fault_seed=s).run(test, rounds=3)
            for s in (4, 4, 5)]
    np.testing.assert_array_equal(runs[0].times, runs[1].times)
    np.testing.assert_array_equal(runs[0].test_loss, runs[1].test_loss)
    assert not np.array_equal(runs[0].times, runs[2].times)
    fc = t_f.faulty_cycle_stats(fm, t_f.deadline_failover_policy(),
                                Key(4, device="cpu"), tsch.problem,
                                tsch.assoc, tsch.a, tsch.b, 3)
    np.testing.assert_array_equal(
        runs[0].times,
        np.cumsum(np.where(fc.down, 0.0, fc.cycle_times).max(axis=1)))

    sampler = t_s.make_sampler("uniform", 0.5)
    a = _tsim(logreg, sampler=sampler, sample_seed=6).run(test, rounds=3)
    b = _tsim(logreg, sampler=sampler, sample_seed=6).run(test, rounds=3)
    np.testing.assert_array_equal(a.test_loss, b.test_loss)
    part = sampler.sample_rounds(Key(6, device="cpu"),
                                 tsch.problem.samples.astype(np.float32),
                                 tsch.assoc.argmax(1), 2, 3)
    rows = DeterministicDelays().cycle_times(None, tsch.problem, tsch.assoc,
                                             tsch.a, tsch.b, 3,
                                             participation=part)
    np.testing.assert_array_equal(a.times, np.cumsum(rows.max(axis=1)))
    asim = _tsim(logreg, mode="async", max_staleness=1, fault_model=fm,
                 sampler=sampler, fault_seed=4, sample_seed=6)
    r1 = asim.run(test, rounds=2)
    r2 = _tsim(logreg, mode="async", max_staleness=1, fault_model=fm,
               sampler=sampler, fault_seed=4, sample_seed=6).run(test,
                                                                 rounds=2)
    assert _plain(r1.timeline.trace) == _plain(r2.timeline.trace)
    np.testing.assert_array_equal(r1.test_loss, r2.test_loss)


def test_validation_as_reference(logreg):
    tsch = logreg[1]
    for build, f, s in ((_tsim, t_f, t_s), (_jsim, j_f, j_s)):
        model = f.FaultModel(dropout=f.BernoulliDropout(0.2))
        with pytest.raises(ValueError, match="solver='gd'"):
            build(logreg, solver="dane", fault_model=model)
        with pytest.raises(ValueError, match="solver='gd'"):
            build(logreg, solver="dane",
                  sampler=s.make_sampler("uniform", 0.5))
    bare = (None, dataclasses.replace(tsch, problem=None)) + logreg[2:]
    with pytest.raises(ValueError, match="schedule.problem"):
        _tsim(bare, fault_model=t_f.FaultModel(
            dropout=t_f.BernoulliDropout(0.2)))
    # the null model and a full sampler route to None before any check
    _tsim(logreg, solver="dane", fault_model=t_f.FaultModel(),
          sampler=t_s.make_sampler("weight", 1.0))
    sim = _tsim(logreg)
    assert sim.fault_policy == t_f.deadline_failover_policy()
