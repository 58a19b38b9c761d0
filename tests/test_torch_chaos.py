"""Live faults, client sampling and the streaming merge through the port's
control plane (``repro_torch.launch.service``) against the JAX package's.

* With the service's delay, fault and cohort keys patched to the
  reference's (``JaxKey``), the trace equals the reference's record for
  record (the clock within rtol 1e-6: float32 draws; masks, outage
  decisions, masses and staleness exactly) and the published model is
  within 1e-5, under each fault scenario (``ue_churn``, ``edge_outage``,
  ``lossy_uplink``), under the unprotected wait-for-all policy, with a
  weight-proportional sampler, and through the streaming merge
  (``merge_stream_chunk``).  The reference's property that the
  unprotected policy stalls behind an outage fails in the reference
  itself, so the port is held to the reference's trace instead.
* The streaming merge folds the cohort's rows on the simulator's device
  (no host copy), one ``segment_sum`` call a chunk, within 1e-5 of the
  direct read.
* The port held to itself: a faulted run resumed from a mid-run
  checkpoint (GC keeping three generations) finishes with the
  uninterrupted run's trace and ``model_err == 0.0``; a cohort whose
  survivors all died is shed at the cloud and its edge event gives an
  exact zero row, never NaN.
* Config validation and the version-2 trace schema, as the reference's
  tests.
"""
import dataclasses
import functools
import math
from unittest import mock

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _service_pair as sp  # noqa: E402

from repro.core import stochastic as j_st  # noqa: E402
from repro.core import faults as j_f  # noqa: E402
from repro.launch import service as js  # noqa: E402
from repro_torch.core import faults as t_f  # noqa: E402
from repro_torch.core import stochastic as t_st  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.kernels import hier_aggregate as ha  # noqa: E402
from repro_torch.launch import service as ts  # noqa: E402

FAULTS = ("ue_churn", "edge_outage", "lossy_uplink")
EVENTS = 45
FAULT_SEED = 7
BOUNDARY = 4.0       # inside the port's own first outage window (seed 7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small operations gain nothing from more,
    and idle threads spinning would slow the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_boundary():
    """A segment boundary inside the reference's first outage window for
    ``fault_seed``: the second segment then opens with an edge down, so
    its orphans fail over (a ``failover`` record)."""
    sim = sp.jsim(**sp.CHEAP)
    sch = sim.schedule
    windows = j_st.scenario("edge_outage").faults.outage.sample_windows(
        jax.random.fold_in(jax.random.PRNGKey(FAULT_SEED), js._OUTAGE_SALT),
        sch.problem, sch.assoc, sch.a, sch.b, js.SERVICE_OUTAGE_HORIZON)
    _, fail, repair = windows[0]
    return 0.5 * (fail + repair)


def _cfg(pkg, name=None, boundary=BOUNDARY, **kw):
    st = j_st if pkg is js else t_st
    if name is not None:
        kw.setdefault("fault_model", st.scenario(name).faults)
        kw.setdefault("fault_seed", FAULT_SEED)
    kw.setdefault("max_staleness", sp.S_MAX)
    segs = sp.segments(pkg, [("deterministic", 1.0, boundary),
                             ("heavy_tail_compute", 0.8, math.inf)])
    return pkg.ServiceConfig(segments=segs, **kw)


def _pair(boundary, name=None, **kw):
    """The reference's and the port's runs of EVENTS events (the port on
    the reference's keys)."""
    jkw = {k: (j_f.wait_for_all_policy() if k == "fault_policy" else v)
           for k, v in kw.items()}
    ref = js.HFLService(sp.jsim(**sp.CHEAP),
                        _cfg(js, name, boundary, **jkw))
    ref.run(EVENTS)
    return ref, _port_on_ref_keys(boundary, name, **kw)


@functools.lru_cache(maxsize=None)
def _port_on_ref_keys(boundary, name=None, **kw):
    with sp.jax_keys():
        svc = ts.HFLService(sp.tsim(**sp.CHEAP),
                            _cfg(ts, name, boundary, **kw))
        svc.run(EVENTS)
    return svc


def _tsvc(name=None, **kw):
    return ts.HFLService(sp.tsim(**sp.CHEAP), _cfg(ts, name, **kw))


@functools.lru_cache(maxsize=None)
def _own_run(name):
    """The port's uninterrupted faulted run on its own keys (read only)."""
    svc = _tsvc(name)
    svc.run(EVENTS)
    return svc


def _assert_pair(ref, svc):
    sp.assert_same_trace(svc.trace, ref.trace)
    assert float(np.abs(svc.g - ref.g).max()) <= sp.ATOL
    assert np.isfinite(svc.g).all()
    assert (svc.fault_shed, svc.shed_jobs, svc.applied) == \
        (ref.fault_shed, ref.shed_jobs, ref.applied)


# ---------------------------------------------------------------------------
# Against the reference, on its keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", FAULTS)
def test_faulted_trace_matches_reference(ref_boundary, name):
    ref, svc = _pair(ref_boundary, name)
    _assert_pair(ref, svc)
    kinds = {r["kind"] for r in ref.trace}
    if name != "edge_outage":
        assert "shed-fault" in kinds        # a cohort died whole
    else:
        assert {"fail", "repair", "failover"} <= kinds
        fo = [r for r in svc.trace if r["kind"] == "failover"]
        assert fo[0]["seg"] == 1 and fo[0]["orphans"] > 0


def test_wait_for_all_trace_matches_reference(ref_boundary):
    ref, svc = _pair(ref_boundary, "edge_outage",
                     fault_policy=t_f.wait_for_all_policy())
    _assert_pair(ref, svc)
    assert not svc.config.fault_policy.failover
    assert not any(r["kind"] == "failover" for r in svc.trace)


def test_sampled_trace_matches_reference(ref_boundary):
    ref, svc = _pair(ref_boundary, sampler="weight",
                     participation_rate=0.5, sample_seed=3)
    _assert_pair(ref, svc)
    for c in (1, 5, 9):
        np.testing.assert_array_equal(svc._participation_mask(c),
                                      ref._participation_mask(c))


def test_streaming_merge_matches_reference(ref_boundary):
    ref, svc = _pair(ref_boundary, "ue_churn", merge_stream_chunk=2)
    _assert_pair(ref, svc)
    direct = _port_on_ref_keys(ref_boundary, "ue_churn")
    assert float(np.abs(direct.g - svc.g).max()) <= 1e-5
    assert [(r["edge"], r["cycle"]) for r in direct.trace
            if r["kind"] == "merge"] == \
        [(r["edge"], r["cycle"]) for r in svc.trace if r["kind"] == "merge"]


# ---------------------------------------------------------------------------
# The port held to itself
# ---------------------------------------------------------------------------


def test_streaming_rows_stay_on_the_device():
    """Each merge folds its cohort through the accumulator on the
    simulator's device, one ``segment_sum`` call a chunk, with no host
    copy of the rows."""
    chunk = 2
    svc = _tsvc("ue_churn", merge_stream_chunk=chunk)
    assert svc._stream_acc.device == svc.sim.device
    sizes = np.bincount(svc._gids, minlength=sp.EDGES)
    with mock.patch.object(svc.sim, "hot_rows",
                           side_effect=AssertionError("host copy")), \
            mock.patch.object(ha, "segment_sum",
                              wraps=ha.segment_sum) as seg_sum:
        svc.run(30)
    want = sum(-(-int(sizes[r["edge"]]) // chunk) for r in svc.trace
               if r["kind"] in ("merge", "shed")) + \
        sum(-(-int(sizes[j.edge]) // chunk) for j in svc.queue)
    assert seg_sum.call_count == want


@pytest.mark.parametrize("name", FAULTS)
def test_faulted_resume_parity_is_exact(tmp_path, name):
    ref = _own_run(name)
    cfg = dict(ckpt_dir=str(tmp_path), ckpt_every=10, keep_last_k=3)
    _tsvc(name, **cfg).run(33)
    resumed = _tsvc(name, **cfg)
    assert resumed.restore_latest() is not None
    resumed.run(EVENTS)
    assert float(np.abs(ref.g - resumed.g).max()) == 0.0
    assert sp.merges(resumed, mass=True) == sp.merges(ref, mass=True)
    assert resumed.fault_shed == ref.fault_shed
    assert len([f for f in tmp_path.iterdir()
                if f.name.startswith("ckpt-")]) <= 3


def test_dead_cohorts_are_shed_and_their_rows_exact_zero():
    svc = _own_run("lossy_uplink")
    shed = [r for r in svc.trace if r["kind"] == "shed-fault"]
    assert svc.summary()["fault_shed"] == len(shed) > 0
    assert np.isfinite(svc.g).all()
    for r in svc.trace:
        if r["kind"] == "merge":
            assert r["mass"] == pytest.approx(svc.sim.edge_mass(r["edge"]))
            assert r["mass"] > 0.0
    # a wave in which edge 0's cohort is dead: its edge event gives an
    # exact zero row, never NaN
    sim = sp.tsim(**sp.CHEAP)
    gids = svc._gids
    ok = gids != 0
    sim.replay_departure(svc.g, np.ones_like(ok), ue_ok=ok)
    flat = sim.flat_state()
    assert (flat[gids == 0] == 0.0).all()
    assert np.isfinite(flat).all()


# ---------------------------------------------------------------------------
# Validation and the trace schema
# ---------------------------------------------------------------------------


def test_fault_config_validation():
    with pytest.raises(ValueError, match="max_staleness"):
        _cfg(ts, "ue_churn", max_staleness=0)
    with pytest.raises(ValueError, match="fault_model"):
        _cfg(ts, fault_model="ue_churn")
    with pytest.raises(ValueError, match="fault_model"):
        _cfg(ts, fault_model=j_st.scenario("ue_churn").faults)
    with pytest.raises(ValueError, match="fault_policy"):
        _cfg(ts, "ue_churn", fault_policy="deadline")
    cfg = _cfg(ts, "ue_churn")
    assert isinstance(cfg.fault_policy, t_f.FaultPolicy)
    assert cfg.fault_policy.failover
    with pytest.raises(ValueError, match="keep_last_k"):
        _cfg(ts, keep_last_k=-1)
    with pytest.raises(ValueError, match="merge_stream_chunk"):
        _cfg(ts, merge_stream_chunk=-2)
    # the config echo names each fault process's class, as the reference
    echo_t = _cfg(ts, "edge_outage").to_json()
    echo_j = _cfg(js, "edge_outage").to_json()
    assert echo_t == echo_j
    assert dataclasses.replace(cfg, fault_seed=8).to_json() != cfg.to_json()


def test_trace_roundtrip_with_fault_kinds(tmp_path):
    svc = _tsvc("edge_outage")
    svc.run(EVENTS)
    path = svc.to_jsonl(str(tmp_path / "trace.jsonl"))
    header, records = ts.load_service_trace_jsonl(path)
    assert header["version"] == 2 and len(records) == len(svc.trace)
    kinds = {r["kind"] for r in records}
    assert {"merge", "fail", "repair", "failover"} <= kinds <= \
        ts.SERVICE_TRACE_KINDS
    svc.trace.append(dict(kind="gremlin", t=0.0))
    bad = svc.to_jsonl(str(tmp_path / "bad.jsonl"))
    with pytest.raises(ValueError, match="gremlin"):
        ts.load_service_trace_jsonl(bad)
    lines = open(path).read().splitlines()
    import json
    head = json.loads(lines[0])
    head["version"] = 1
    with open(path, "w") as f:
        f.write("\n".join([json.dumps(head)] + lines[1:]) + "\n")
    with pytest.raises(ValueError, match="version"):
        ts.load_service_trace_jsonl(path)


@pytest.mark.cuda
def test_streaming_merge_on_the_card():
    """On the card the streaming merge launches the segment_sum kernel
    once a chunk and matches the CPU run's model."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = _cfg(ts, "ue_churn", merge_stream_chunk=4)
    sim = ts.default_service_sim(sp.UES, sp.EDGES, max_staleness=sp.S_MAX,
                                 device="cuda")
    svc = ts.HFLService(sim, cfg)
    tracing.reset()
    svc.run(20)
    chunks = sum(-(-int((svc._gids == r["edge"]).sum()) // 4)
                 for r in svc.trace if r["kind"] in ("merge", "shed")) + \
        sum(-(-int((svc._gids == j.edge).sum()) // 4) for j in svc.queue)
    assert ha.launch_counts["segment_sum"] == chunks
    cpu = ts.HFLService(ts.default_service_sim(
        sp.UES, sp.EDGES, max_staleness=sp.S_MAX, device="cpu"), cfg)
    cpu.run(20)
    assert float(np.abs(svc.g - cpu.g).max()) <= sp.ATOL
