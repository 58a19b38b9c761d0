"""The port's planning core, synthetic data and partitions against the JAX
package: numpy-only in both, so the outputs must be EXACTLY equal."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import assoc as j_assoc  # noqa: E402
from repro.core import delay as j_delay  # noqa: E402
from repro.core import events as j_events  # noqa: E402
from repro.core.problem import HFLProblem as JProblem  # noqa: E402
from repro.core.schedule import plan as j_plan  # noqa: E402
from repro.data import partition as j_part  # noqa: E402
from repro.data import synthetic as j_syn  # noqa: E402
from repro_torch.core import assoc as t_assoc  # noqa: E402
from repro_torch.core import delay as t_delay  # noqa: E402
from repro_torch.core import events as t_events  # noqa: E402
from repro_torch.core.problem import HFLProblem as TProblem  # noqa: E402
from repro_torch.core.schedule import plan as t_plan  # noqa: E402
from repro_torch.data import partition as t_part  # noqa: E402
from repro_torch.data import synthetic as t_syn  # noqa: E402

TOPOLOGIES = {
    "paper_5x100": dict(num_edges=5, num_ues=100),
    "quickstart_2x8": dict(num_edges=2, num_ues=8, samples_lo=50,
                           samples_hi=120),
    "mid_3x30": dict(num_edges=3, num_ues=30),
}


def _same_schedule(js, ts):
    assert (ts.a, ts.b, ts.rounds) == (js.a, js.b, js.rounds)
    assert ts.cloud_round_time == js.cloud_round_time
    assert ts.total_delay == js.total_delay
    np.testing.assert_array_equal(ts.assoc, js.assoc)
    np.testing.assert_array_equal(ts.edge_round_time, js.edge_round_time)
    assert ts.meta == js.meta


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_plan_matches_reference_over_seeds(topo):
    for seed in range(10):
        kw = dict(TOPOLOGIES[topo], epsilon=0.25, seed=seed)
        _same_schedule(j_plan(JProblem(**kw)), t_plan(TProblem(**kw)))


@pytest.mark.parametrize("association,solver", [
    ("proposed", "dual"), ("refined", "direct"), ("cluster", "direct"),
    ("greedy", "direct"), ("random", "direct")])
def test_plan_strategies_and_solvers_match_reference(association, solver):
    for seed in range(3):
        kw = dict(num_edges=3, num_ues=24, epsilon=0.1, seed=seed)
        _same_schedule(
            j_plan(JProblem(**kw), association=association, solver=solver,
                   seed=seed),
            t_plan(TProblem(**kw), association=association, solver=solver,
                   seed=seed))


def test_problem_and_delay_terms_match_reference():
    kw = dict(num_edges=4, num_ues=40, seed=3)
    jp, tp = JProblem(**kw), TProblem(**kw)
    for f in ("ue_pos", "edge_pos", "gains", "cycles", "samples",
              "backhaul"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
    A = j_assoc.proposed(jp)
    np.testing.assert_array_equal(t_assoc.proposed(tp), A)
    jb = j_delay.objective_breakdown(jp, A, 7, 3)
    tb = t_delay.objective_breakdown(tp, A, 7, 3)
    assert jb.keys() == tb.keys()
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])
    assert (t_delay.association_latency(tp, A, 7)
            == j_delay.association_latency(jp, A, 7))


@pytest.mark.parametrize("max_staleness", [0, 2])
def test_async_timeline_matches_reference(max_staleness):
    jp = JProblem(num_edges=4, num_ues=20, seed=1)
    tp = TProblem(num_edges=4, num_ues=20, seed=1)
    A = j_assoc.proposed(jp)
    jr = j_delay.async_completion(jp, A, 5, 3, rounds=6,
                                  max_staleness=max_staleness)
    tr = t_delay.async_completion(tp, A, 5, 3, rounds=6,
                                  max_staleness=max_staleness)
    assert tr["arrivals"] == jr["arrivals"]
    for k in ("makespan", "sync_makespan", "speedup", "cloud_idle_frac"):
        assert tr[k] == jr[k]
    np.testing.assert_array_equal(tr["edge_busy_frac"], jr["edge_busy_frac"])
    cycles = np.array([3.0, 5.0, 7.5])
    jt = j_events.simulate_async(cycles, rounds=4,
                                 max_staleness=max_staleness)
    tt = t_events.simulate_async(cycles, rounds=4,
                                 max_staleness=max_staleness)
    assert _plain(tt.trace) == _plain(jt.trace)
    assert tt.makespan == jt.makespan


def _plain(trace):
    """Trace records as tuples (the two packages' event classes differ)."""
    return [(kind, dataclasses.astuple(ev)) for kind, ev in trace]


def test_refined_stochastic_objectives_raise(monkeypatch):
    """The stochastic objectives draw on a device: an int key with no
    ``device`` raises without a card, and ``device="cpu"`` runs."""
    import torch
    p = TProblem(num_edges=2, num_ues=6, seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for objective in ("quantile_makespan", "joint"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_assoc.refined(p, objective=objective, num_trials=2,
                            max_moves=1)
        A = t_assoc.refined(p, objective=objective, num_trials=2,
                            max_moves=1, device="cpu")
        assert (A.sum(1) == 1).all()


def _bytes_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_synthetic_data_and_partitions_byte_identical():
    for (jx, tx) in [(j_syn.synthetic_mnist(seed=2, n_train=300, n_test=50),
                      t_syn.synthetic_mnist(seed=2, n_train=300, n_test=50))]:
        for jd, td in zip(jx, tx):
            for k in jd:
                _bytes_equal(jd[k], td[k])
    jl = j_syn.logreg_data(seed=1, n=200, dim=12, num_classes=4)
    tl = t_syn.logreg_data(seed=1, n=200, dim=12, num_classes=4)
    for k in jl:
        _bytes_equal(jl[k], tl[k])
    sizes = JProblem(num_edges=2, num_ues=8, seed=0).samples.astype(int)
    cases = [
        (j_part.size_partition, t_part.size_partition, (800, sizes)),
        (j_part.iid_partition, t_part.iid_partition, (100, 7)),
        (j_part.dirichlet_partition, t_part.dirichlet_partition,
         (jl["labels"], 5)),
    ]
    for jf, tf, args in cases:
        jp = jf(np.random.default_rng(4), *args)
        tp = tf(np.random.default_rng(4), *args)
        assert len(jp) == len(tp)
        for a, b in zip(jp, tp):
            _bytes_equal(a, b)
