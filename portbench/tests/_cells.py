"""What the tests share: the cells of BENCHMARK.json, and one run of a
cell at the smoke sizes of its files, on the CPU."""
import json
import sys

from harness import bench


def cells() -> list:
    return [w["name"] for w in bench.load_benchmark()["workloads"]]


def smoke_run(capsys, cell: str, trace: int = 0, seed: int = 2147483661,
              seconds: float = 1.0, hook=None, root=None) -> dict:
    """The result line of a smoke run of ``cell`` on the CPU (the
    harness's look for a chip skipped), as a dict."""
    import run
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], device="cpu",
                  smoke=True, entry_hook=hook, root=root)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])
