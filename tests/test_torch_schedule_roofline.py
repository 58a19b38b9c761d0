"""The roofline half of the port's schedule (``problem_from_roofline``,
``plan_from_roofline``) and its twin example
(``examples/hfl_transformer_torch.py``) against the JAX package, on the
CPU, exactly: the same roofline terms give the same problem field for
field and the same schedule.  The reference's TPU link rates are passed
to both; the port's defaults are the H100's NVLink and InfiniBand rates.

The example runs 4 gloo ranks on the CPU (``spawn`` imports it in each
rank, from ``examples/`` on ``sys.path``).
"""
import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import schedule as t_sched  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "examples"))

import hfl_transformer_torch as twin  # noqa: E402

REFERENCE_LINKS = dict(ici_bw=50e9, dcn_bw=6.25e9)
ROOFLINES = [
    {"compute_s": 0.012, "memory_s": 0.24, "collective_s": 1.34},
    {"compute_s": 0.175, "memory_s": 0.031, "collective_s": 0.0},
    {"compute_s": 2.5e-3, "memory_s": 4.0e-3, "collective_s": 0.02},
]
MESHES = [(2, 4, 3.2e9), (3, 5, 6.577e9), (4, 2, 1.0e8)]


def _assert_same(a, b, what):
    if isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=what)
    else:
        assert a == b, what


@pytest.mark.parametrize("roofline, mesh", list(zip(ROOFLINES, MESHES)))
def test_problem_from_roofline_equals_reference(roofline, mesh):
    """Every field of the HFLProblem (arrays and scalars) and its meta."""
    from repro.core import schedule as j_sched
    E, U, nbytes = mesh
    kw = dict(num_edges=E, ues_per_edge=U, model_bytes=nbytes,
              **REFERENCE_LINKS)
    got = t_sched.problem_from_roofline(roofline, **kw)
    want = j_sched.problem_from_roofline(roofline, **kw)
    assert sorted(vars(got)) == sorted(vars(want))
    assert {f.name for f in dataclasses.fields(want)} <= set(vars(want))
    for name, value in vars(want).items():
        _assert_same(getattr(got, name), value, name)
    assert got.meta == want.meta


@pytest.mark.parametrize("roofline, mesh", list(zip(ROOFLINES, MESHES)))
def test_plan_from_roofline_equals_reference(roofline, mesh):
    from repro.core import schedule as j_sched
    E, U, nbytes = mesh
    kw = dict(num_edges=E, ues_per_edge=U, model_bytes=nbytes,
              **REFERENCE_LINKS)
    got = t_sched.plan_from_roofline(roofline, **kw)
    want = j_sched.plan_from_roofline(roofline, **kw)
    assert (got.a, got.b, got.rounds) == (want.a, want.b, want.rounds)
    np.testing.assert_array_equal(got.assoc, want.assoc)
    assert got.total_delay == want.total_delay
    assert got.cloud_round_time == want.cloud_round_time
    np.testing.assert_array_equal(got.edge_round_time, want.edge_round_time)
    assert got.problem.meta == want.problem.meta


def test_plan_from_roofline_defaults_to_the_h100_links():
    """Without link rates the port takes NVLink 4 and NDR InfiniBand (each
    way): the reference's plan given those rates."""
    from repro.core import schedule as j_sched
    kw = dict(num_edges=2, ues_per_edge=4, model_bytes=6_577_070_080)
    got = t_sched.plan_from_roofline(ROOFLINES[1], **kw)
    want = j_sched.plan_from_roofline(ROOFLINES[1], ici_bw=t_mesh.NVLINK_BW,
                                      dcn_bw=t_mesh.IB_BW, **kw)
    assert (got.a, got.b, got.rounds, got.cloud_round_time) == \
        (want.a, want.b, want.rounds, want.cloud_round_time)
    assert got.problem.meta["t_sync_edge"] == 6_577_070_080 / 450e9
    assert got.problem.meta["t_sync_cloud"] == 6_577_070_080 / 50e9


def test_twin_plan_on_the_reference_links_reads_the_reference_line():
    """The twin at the reference example's 2 x 4 with the TPU links: a=2
    b=22 R=2, T = 16.72 s, the line the reference's plan gives."""
    from repro.core import schedule as j_sched
    args = twin.parse_args(["--edge-bw", "50e9", "--cloud-bw", "6.25e9"])
    line = twin.plan_line(twin.schedule(args))
    assert line == "plan_from_roofline: a=2 b=22 R=2 cloud-round T=16.72s"
    assert line == twin.plan_line(j_sched.plan_from_roofline(
        twin.ROOFLINE, num_edges=2, ues_per_edge=4,
        model_bytes=twin.MODEL_BYTES))


def test_twin_example_runs_on_four_cpu_ranks(capsys):
    """``main`` at 2 x 2, one cloud round on the CPU: the plan line is the
    reference's plan on the same links, the losses finite, and every
    rank's params equal after the cloud round."""
    from repro.core import schedule as j_sched
    out = twin.main(["--edges", "2", "--ues-per-edge", "2", "--rounds", "1",
                     "--device", "cpu"])
    want = j_sched.plan_from_roofline(
        twin.ROOFLINE, num_edges=2, ues_per_edge=2,
        model_bytes=twin.MODEL_BYTES, ici_bw=t_mesh.NVLINK_BW,
        dcn_bw=t_mesh.IB_BW)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == twin.plan_line(want)
    sch = out["schedule"]
    assert (sch.a, sch.b, sch.rounds, sch.cloud_round_time) == \
        (want.a, want.b, want.rounds, want.cloud_round_time)
    assert len(out["ranks"]) == 4
    for rank in out["ranks"]:
        assert len(rank["losses"]) == 1
        assert np.isfinite(rank["losses"]).all()
    assert out["equal"] and out["agreement"] == 0.0
    assert lines[-1] == "replica agreement after cloud round: 0.0"
