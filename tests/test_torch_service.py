"""The port's always-on control plane (``repro_torch.launch.service``)
against the JAX package's ``repro.launch.service``.

* ``default_service_sim`` builds the reference's federation and schedule.
* With the service's keys patched to the reference's (``JaxKey``), the
  trace equals the reference's record for record (the clock within rtol
  1e-6: float32 draws) and the published model is within 1e-5, in the
  plain (no shedding), shedding and scenario-switch cases.
* The port held to itself: two runs give the same trace and model; a run
  resumed from a mid-run checkpoint (also across a scenario boundary, also
  after falling back over a corrupted newest file) finishes with the
  uninterrupted run's trace and ``model_err == 0.0``; a real ``kill -9``
  of the CLI (``python -m repro_torch.launch.service``) at the
  reference's sizes resumes to the uninterrupted trace, the model within
  the reference's 1e-6.
* Config validation, foreign-config rejection and the trace export, as
  the reference's tests.

Most cases run on ``_service_pair.CHEAP``'s schedule (a* = 3, b* = 4)
with segments scaled to its cycle times; the SIGKILL case runs
``default_service_sim`` as the reference's test does.
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _service_pair as sp  # noqa: E402

from repro.launch import service as js  # noqa: E402
from repro_torch.checkpoint import (CheckpointError,  # noqa: E402
                                    list_checkpoints)
from repro_torch.launch import service as ts  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
BURST = [("iid_campus", 1.0, 15.0), ("iid_campus", 4.0, 15.0),
         ("iid_campus", 1.0, float("inf"))]
SWITCH = [("iid_campus", 1.0, 8.0), ("urban_stragglers", 1.0, 15.0),
          ("flaky_uplink", 2.0, float("inf"))]
CASES = {"plain": (BURST, dict(shed=False)), "shed": (BURST, {}),
         "switch": (SWITCH, {})}
EVENTS = 60
KILL_EVENTS = 30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small operations gain nothing from more,
    and idle threads spinning would slow the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(pkg, spec=BURST, **kw):
    kw.setdefault("max_staleness", sp.S_MAX)
    return pkg.ServiceConfig(segments=sp.segments(pkg, spec), **kw)


def _tsvc(spec=BURST, **kw):
    return ts.HFLService(sp.tsim(**sp.CHEAP), _cfg(ts, spec, **kw))


@pytest.fixture(scope="module")
def port_runs():
    """The port's uninterrupted runs, one per case (own keys)."""
    out = {}
    for name in ("shed", "switch"):
        spec, kw = CASES[name]
        svc = _tsvc(spec, **kw)
        svc.run(EVENTS)
        out[name] = svc
    return out


def test_default_service_sim_matches_reference():
    j = js.default_service_sim(sp.UES, sp.EDGES, max_staleness=sp.S_MAX)
    t = ts.default_service_sim(sp.UES, sp.EDGES, max_staleness=sp.S_MAX,
                               device="cpu")
    assert (t.schedule.a, t.schedule.b) == (j.schedule.a, j.schedule.b)
    np.testing.assert_array_equal(t.schedule.assoc, j.schedule.assoc)
    np.testing.assert_array_equal(t.flat_state(), j.flat_state())
    np.testing.assert_array_equal(t.weights.numpy(),
                                  np.asarray(j._hot_weights))
    assert (t.mode, t.max_staleness, t.staleness_decay) == \
        (j.mode, j.max_staleness, j.staleness_decay)


@pytest.mark.parametrize("case", sorted(CASES))
def test_trace_matches_reference_on_its_keys(case):
    spec, kw = CASES[case]
    ref = js.HFLService(sp.jsim(**sp.CHEAP), _cfg(js, spec, **kw))
    ref.run(EVENTS)
    with sp.jax_keys():
        svc = _tsvc(spec, **kw)
        svc.run(EVENTS)
    sp.assert_same_trace(svc.trace, ref.trace)
    assert float(np.abs(svc.g - ref.g).max()) <= sp.ATOL
    s, r = svc.summary(), ref.summary()
    for k in ("events", "applied", "shed", "fault_shed", "backlog_peak"):
        assert s[k] == r[k], k
    assert s["merge_cost"] == r["merge_cost"]
    assert s["p95"] == pytest.approx(r["p95"], rel=1e-5)
    if case == "shed":
        assert r["shed"] > 0
        assert any(x["kind"] == "degraded" and x["on"] for x in ref.trace)
    if case == "plain":
        assert s["shed"] == 0
    if case == "switch":
        assert ref.clock > 23.0        # both segment boundaries crossed


def test_run_is_deterministic(port_runs):
    spec, kw = CASES["shed"]
    svc = _tsvc(spec, **kw)
    svc.run(EVENTS)
    ref = port_runs["shed"]
    assert sp.merges(svc) == sp.merges(ref)
    np.testing.assert_array_equal(svc.g, ref.g)


@pytest.mark.parametrize("case,stop", [("shed", 30), ("switch", 40)])
def test_resume_matches_uninterrupted(port_runs, tmp_path, case, stop):
    """Stop at an event boundary (``switch``: inside the urban_stragglers
    segment) and resume in a fresh service from disk: the trace goes on
    exactly and the model is bit for bit the uninterrupted run's."""
    spec, kw = CASES[case]
    victim = _tsvc(spec, ckpt_dir=str(tmp_path), ckpt_every=10, **kw)
    victim.run(stop)
    if case == "switch":
        assert victim.clock > 8.0
    resumed = _tsvc(spec, ckpt_dir=str(tmp_path), ckpt_every=10, **kw)
    src = resumed.restore_latest()
    assert src.endswith(f"ckpt-{stop // 10}.npz")
    assert resumed.events_done == stop
    resumed.run(EVENTS)
    ref = port_runs[case]
    assert sp.merges(resumed) == sp.merges(ref)
    assert float(np.abs(resumed.g - ref.g).max()) == 0.0
    assert any(r["kind"] == "resume" for r in resumed.trace)


def test_restore_falls_back_over_corrupted_newest(port_runs, tmp_path):
    cfg = dict(ckpt_dir=str(tmp_path), ckpt_every=10)
    _tsvc(**cfg).run(25)                     # ckpts at 10, 20 + final at 25
    paths = list_checkpoints(str(tmp_path))
    assert len(paths) == 3
    with open(paths[-1], "r+b") as f:
        f.truncate(100)
    fresh = _tsvc(**cfg)
    assert fresh.restore_latest() == paths[-2]
    assert fresh.events_done == 20
    fresh.run(EVENTS)
    ref = port_runs["shed"]
    assert sp.merges(fresh) == sp.merges(ref)
    assert float(np.abs(fresh.g - ref.g).max()) == 0.0
    for p in list_checkpoints(str(tmp_path))[:-1]:
        with open(p, "r+b") as f:
            f.truncate(50)
    with open(list_checkpoints(str(tmp_path))[-1], "r+b") as f:
        f.truncate(50)
    with pytest.raises(CheckpointError, match="no readable checkpoint"):
        _tsvc(**cfg).restore_latest()


def test_restore_rejects_foreign_config(tmp_path):
    _tsvc(ckpt_dir=str(tmp_path), ckpt_every=10).run(10)
    with pytest.raises(CheckpointError, match="different service config"):
        _tsvc(ckpt_dir=str(tmp_path), ckpt_every=10,
              delay_seed=7).restore_latest()


def test_checkpoint_is_the_reference_schema(tmp_path):
    """The port's checkpoint tree and config echo are the reference's,
    key for key, and each package's config serialises the same."""
    from repro.checkpoint import load_pytree as j_load
    t = _tsvc(ckpt_dir=str(tmp_path / "t"), ckpt_every=10)
    t.run(10)
    j = js.HFLService(sp.jsim(**sp.CHEAP),
                      _cfg(js, ckpt_dir=str(tmp_path / "j"), ckpt_every=10))
    j.run(10)
    ttree, tmeta = j_load(list_checkpoints(str(tmp_path / "t"))[-1])
    jtree, jmeta = j_load(list_checkpoints(str(tmp_path / "j"))[-1])

    def keys(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(keys(v, f"{prefix}{k}/"))
            else:
                out[prefix + k] = (np.asarray(v).dtype.kind,
                                   np.asarray(v).ndim)
        return out

    assert keys(ttree) == keys(jtree)
    assert int(tmeta["schema"]) == int(jmeta["schema"]) == \
        ts.SERVICE_CKPT_VERSION
    echo = [json.loads(str(m["config"])) for m in (tmeta, jmeta)]
    assert [e.pop("ckpt_dir") for e in echo] == [str(tmp_path / "t"),
                                                 str(tmp_path / "j")]
    assert echo[0] == echo[1]
    assert (ts.SERVICE_TRACE_SCHEMA, ts.SERVICE_TRACE_VERSION,
            ts.SERVICE_TRACE_KINDS) == (js.SERVICE_TRACE_SCHEMA,
                                        js.SERVICE_TRACE_VERSION,
                                        js.SERVICE_TRACE_KINDS)


def test_trace_jsonl_roundtrip(tmp_path):
    svc = _tsvc()
    svc.run(30)
    path = svc.to_jsonl(str(tmp_path / "svc.jsonl"))
    header, records = ts.load_service_trace_jsonl(path)
    assert header["num_records"] == len(svc.trace) == len(records)
    assert header["summary"]["applied"] == svc.summary()["applied"]
    # the reference reads the port's export
    assert js.load_service_trace_jsonl(path)[1] == records
    lines = open(path).read().splitlines()
    hdr = json.loads(lines[0])
    (tmp_path / "bad.jsonl").write_text(
        "\n".join([json.dumps(dict(hdr, version=99))] + lines[1:]))
    with pytest.raises(ValueError, match="unknown service trace version"):
        ts.load_service_trace_jsonl(str(tmp_path / "bad.jsonl"))
    (tmp_path / "trunc.jsonl").write_text("\n".join(lines[:-1]))
    with pytest.raises(ValueError, match="truncated"):
        ts.load_service_trace_jsonl(str(tmp_path / "trunc.jsonl"))


def test_config_validation():
    S = ts.Segment
    with pytest.raises(ValueError, match="max_staleness >= 1"):
        ts.ServiceConfig(max_staleness=0)
    with pytest.raises(ValueError, match="degraded_staleness"):
        ts.ServiceConfig(max_staleness=2, degraded_staleness=3)
    with pytest.raises(ValueError, match="backlog_low"):
        ts.ServiceConfig(backlog_low=8, backlog_high=8)
    with pytest.raises(ValueError, match="ue_shed_frac"):
        ts.ServiceConfig(ue_shed_frac=1.0)
    with pytest.raises(ValueError, match="unknown scenario"):
        ts.ServiceConfig(segments=(S("nope"),))
    with pytest.raises(ValueError, match="non-final segment"):
        ts.ServiceConfig(segments=(S("deterministic", 1.0, float("inf")),
                                   S("deterministic", 1.0, 10.0)))
    with pytest.raises(ValueError, match="load"):
        ts.ServiceConfig(segments=(S("deterministic", -1.0),))
    with pytest.raises(ValueError, match="participation_rate"):
        ts.ServiceConfig(participation_rate=0.0)
    with pytest.raises(ValueError, match="unknown sampler"):
        ts.ServiceConfig(sampler="nope", participation_rate=0.5)
    sim = sp.tsim(**sp.CHEAP)
    with pytest.raises(ValueError, match="max_staleness"):
        ts.HFLService(sim, ts.ServiceConfig(max_staleness=sp.S_MAX + 1))
    sync = sp.tsim(**sp.CHEAP)
    sync.mode = "sync"
    with pytest.raises(ValueError, match="mode='async'"):
        ts.HFLService(sync, ts.ServiceConfig(max_staleness=sp.S_MAX))
    with pytest.raises(ValueError, match="ckpt_dir"):
        ts.HFLService(sim, ts.ServiceConfig(max_staleness=sp.S_MAX)
                      ).checkpoint()


def test_sigkill_crash_resume_parity(tmp_path):
    """A real kill -9 of the CLI mid-run at the reference test's
    federation (12 UEs, 3 edges, ``default_service_sim``; 30 events, not
    60, to keep the file's time): resume from the surviving checkpoints
    and match the uninterrupted in-process run's merge trace, the model
    within the reference's 1e-6."""
    segs = "iid_campus:1.0:40,iid_campus:4.0:40,iid_campus:1.0:inf"
    argv = ["--device", "cpu", "--ues", str(sp.UES), "--edges",
            str(sp.EDGES), "--max-staleness", str(sp.S_MAX), "--segments",
            segs, "--max-updates", str(KILL_EVENTS), "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "5"]
    victim = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.service", *argv],
        env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"),
        stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    deadline = time.time() + 240
    try:
        while len(list_checkpoints(str(tmp_path))) < 2:
            assert victim.poll() is None, \
                f"victim finished before the kill (rc={victim.returncode})"
            assert time.time() < deadline, "no checkpoints appeared"
            time.sleep(0.05)
        victim.send_signal(signal.SIGKILL)
        victim.wait(timeout=30)
    finally:
        if victim.poll() is None:
            victim.kill()
            victim.wait(timeout=30)
    assert victim.returncode == -signal.SIGKILL

    def svc(**kw):
        cfg = ts.ServiceConfig(segments=ts._parse_segments(segs),
                               max_staleness=sp.S_MAX, **kw)
        return ts.HFLService(ts.default_service_sim(
            sp.UES, sp.EDGES, max_staleness=sp.S_MAX, device="cpu"), cfg)

    resumed = svc(ckpt_dir=str(tmp_path), ckpt_every=5)
    assert resumed.restore_latest() is not None
    assert resumed.events_done < KILL_EVENTS
    resumed.run(KILL_EVENTS)
    ref = svc()
    ref.run(KILL_EVENTS)
    assert sp.merges(resumed) == sp.merges(ref)
    assert float(np.abs(resumed.g - ref.g).max()) <= 1e-6


@pytest.mark.cuda
def test_service_on_the_card():
    """Device placement: the simulator's flat buffer on the card, the
    published vector on the host, the same trace as on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim = ts.default_service_sim(sp.UES, sp.EDGES, max_staleness=sp.S_MAX,
                                 device="cuda")
    assert sim._flat.device.type == "cuda"
    svc = ts.HFLService(sim, _cfg(ts))
    svc.run(20)
    cpu = ts.HFLService(ts.default_service_sim(
        sp.UES, sp.EDGES, max_staleness=sp.S_MAX, device="cpu"), _cfg(ts))
    cpu.run(20)
    assert sp.merges(svc) == sp.merges(cpu)
    assert float(np.abs(svc.g - cpu.g).max()) <= sp.ATOL
