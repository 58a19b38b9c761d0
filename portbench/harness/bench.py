"""Cells, configurations, traffic mixes, entries and metrics, found by name.

``BENCHMARK.json`` at the root of the checkout lists the cells.  A cell
names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); the mix names the entry that drives the
window (``entries/<entry>.py``); every metric is a file of its own
(``metrics/<name>.py``).  Adding a cell, a configuration, a mix, an entry
or a metric is adding files and entries: nothing here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]          # portbench/
REPO = HERE.parent


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root=REPO) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def load_module(path, name: str = None):
    """The Python file ``path`` as a module (names such as ``idle.round``
    are no identifiers, so the file is loaded by its path)."""
    path = Path(path)
    name = name or "portbench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    entry_path: Path
    end_to_end: list        # the cell's end-to-end metric entries
    per_layer: list         # the cell's per-layer metric entries

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, name: str, base=HERE) -> Cell:
    """The cell ``name`` of ``bench`` with its files read."""
    base = Path(base)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(cells: {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = load_json(base.parent / cfg_entry["file"])
    traffic = load_json(base / "traffic" / f"{w['traffic']}.json")
    entry = base / "entries" / f"{traffic['entry']}.py"
    if not entry.exists():
        raise FileNotFoundError(f"traffic {w['traffic']!r} names entry "
                                f"{traffic['entry']!r}: no {entry}")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    per = [m for m in bench["per_layer"] if _applies(m, name)]
    return Cell(name, w, config, traffic, entry, e2e, per)


def metric_module(name: str, base=HERE):
    """``metrics/<name>.py``: ``value(rec)`` for an end-to-end metric,
    ``read(rec)`` for a per-layer one (``None`` where it finds nothing)."""
    path = Path(base) / "metrics" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"metric {name!r} has no file {path}")
    return load_module(path, "portbench_metric_" + name.replace(".", "_")
                       .replace("-", "_"))
