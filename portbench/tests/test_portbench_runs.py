"""A tiny run of every cell, at the smoke sizes of its configuration and
traffic files, prints a well-formed last line."""
import pytest

from _cells import cells, smoke_run
from harness import bench

KEYS = ("correct", "attempted", "failed", "metrics", "device", "compared")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", cells())
def test_smoke_run_prints_a_result_line(capsys, cell, trace):
    line = smoke_run(capsys, cell, trace)
    assert list(line)[-1] == "compared"
    for k in KEYS:
        assert k in line
    assert line["attempted"] >= 1 and line["failed"] == 0
    c = bench.resolve(bench.load_benchmark(), cell)
    want = {m["name"]: m["unit"] for m in
            (c.per_layer if trace else c.end_to_end)}
    for name, m in line["metrics"].items():
        assert want[name] == m["unit"]
        assert isinstance(m["value"], float)
    if not trace:
        # every end-to-end metric of the cell, with a positive value
        assert set(line["metrics"]) == set(want)
        assert all(m["value"] > 0 for m in line["metrics"].values())
    for name, cmp_ in line["compared"].items():
        assert set(cmp_) == {"value", "limit"}
