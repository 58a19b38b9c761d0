"""BENCHMARK.json keeps to the benchmark's contract, and every cell,
configuration, traffic mix, entry, limit and metric is found by name from
files of its own; a cell is added from new files alone."""
import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from _cells import cells, smoke_run
from harness import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract():
    b = bench.load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", ()):
            c = bench.resolve(b, w)
            assert m["moves"] in {x["name"] for x in c.end_to_end}
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", cells())
def test_cell_resolves_from_its_files(cell):
    b = bench.load_benchmark()
    c = bench.resolve(b, cell)
    assert c.config["name"] == c.workload["config"]
    assert c.entry_path.exists()
    assert (bench.HERE / "limits" / f"{cell}.json").exists()
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.end_to_end:
        assert hasattr(bench.metric_module(m["name"]), "value")
    for m in c.per_layer:
        assert hasattr(bench.metric_module(m["name"]), "read")


def test_every_config_is_used_and_has_its_own_file():
    b = bench.load_benchmark()
    used = {w["config"] for w in b["workloads"]}
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    for c in b["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        assert json.loads((bench.REPO / c["file"]).read_text())["reduced"] \
            == c["reduced"]


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_is_added_from_new_files_alone(tmp_path, capsys):
    """A new traffic mix, its limits, a new per-layer metric and a new
    cell in BENCHMARK.json, in a copy: no file that was there changes, and
    the new cell runs."""
    shutil.copytree(bench.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(bench.REPO / "BENCHMARK.json", tmp_path)
    before = _digest(tmp_path / "portbench")
    pb = tmp_path / "portbench"
    mix = json.loads((pb / "traffic" / "paper-sync.json").read_text())
    mix["check_rounds"] = 2
    (pb / "traffic" / "paper-sync-two.json").write_text(json.dumps(mix))
    limits = json.loads((pb / "limits" / "lenet-sync-paper.json")
                        .read_text())
    (pb / "limits" / "lenet-sync-two.json").write_text(json.dumps(limits))
    (pb / "metrics" / "rounds.window.py").write_text(
        "def read(rec):\n    return float(rec['units'])\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "lenet-sync-two",
                           "config": "lenet-mnist-paper",
                           "traffic": "paper-sync-two", "chips": 1,
                           "why": "a cell added by files alone"})
    for m in b["end_to_end"]:
        if m["name"] == "round_s":
            m["workloads"].append("lenet-sync-two")
    b["per_layer"].append({"name": "rounds.window", "unit": "rounds",
                           "better": "higher", "source": "host_clock",
                           "layer": "whole round, fl/sim.py",
                           "moves": "round_s",
                           "workloads": ["lenet-sync-two"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    after = _digest(pb)
    assert {k: after[k] for k in before} == before
    line = smoke_run(capsys, "lenet-sync-two", trace=0, root=tmp_path)
    assert set(line["metrics"]) == {"round_s", "setup_s"}
    line = smoke_run(capsys, "lenet-sync-two", trace=1, root=tmp_path)
    assert line["metrics"]["rounds.window"]["value"] >= 1
    assert line["correct"] is True
