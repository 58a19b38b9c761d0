"""No run loads JAX, its libraries or the JAX package: the top-level name
of every module a run of each cell, the references and the metrics load
is compared whole against ``jax``, ``jaxlib``, ``flax`` and ``repro``."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from harness import bench, runtime

SCRIPT = r"""
import glob, io, json, os, sys, contextlib
sys.path.insert(0, "portbench"); sys.path.insert(0, "src")
import run
from harness import bench
for cell in [w["name"] for w in bench.load_benchmark()["workloads"]]:
    for trace in ("0", "1"):
        with contextlib.redirect_stdout(io.StringIO()):
            assert run.main(["--workload", cell, "--seed", "3", "--seconds",
                             "0.2", "--trace", trace], device="cpu",
                            smoke=True) == 0
for path in glob.glob("portbench/metrics/*.py"):
    bench.load_module(path)
import reference.qwen_moe, reference.lenet_hfl, reference.hfl_clock
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def test_a_run_loads_no_jax_and_not_the_jax_package():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=bench.REPO,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops and "torch" in tops
    assert not tops & set(runtime.FORBIDDEN), tops & set(runtime.FORBIDDEN)


@pytest.mark.parametrize("loaded,found", [
    ({"repro_torch": 0, "repro_torch.fl.sim": 0, "reprox": 0}, []),
    ({"repro": 0, "repro_torch": 0}, ["repro"]),
    ({"repro.core.schedule": 0}, ["repro"]),
    ({"jaxlib.xla_client": 0, "jax": 0}, ["jax", "jaxlib"]),
    ({"flax.linen": 0}, ["flax"]),
])
def test_forbidden_names_compare_whole(loaded, found):
    assert runtime.forbidden_loaded(loaded) == found


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints no
    result line; so does a checkout that holds only BENCHMARK.json and
    the benchmark's folder (no program to run)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would measure")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "lenet-sync-paper", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=bench.REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
    assert "no result" in out.stderr


STUB = """import sys, types
sys.modules.setdefault("jax", types.ModuleType("jax"))

def {fn}(rec):
    return 1.0
"""


@pytest.mark.parametrize("trace", [0, 1])
def test_a_metric_that_loads_jax_stops_the_result(tmp_path, capsys, trace):
    """A metric file added in a copy loads a stand-in ``jax`` when the
    harness reads it, after the window: the run prints no result."""
    import run
    shutil.copytree(bench.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    b = bench.load_benchmark()
    kind, fn = ("per_layer", "read") if trace else ("end_to_end", "value")
    entry = {"name": "probe.jax", "unit": "s", "better": "lower",
             "source": "host_clock", "workloads": ["qwen-moe-prefill-4k"]}
    if trace:
        entry.update(layer="device", moves="prefill_tokens_per_s")
    else:
        entry["bound"] = 0.25
    b[kind].append(entry)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    (tmp_path / "portbench" / "metrics" / "probe.jax.py").write_text(
        STUB.format(fn=fn))
    try:
        rc = run.main(["--workload", "qwen-moe-prefill-4k", "--seed", "5",
                       "--seconds", "0.2", "--trace", str(trace)],
                      device="cpu", smoke=True, root=tmp_path)
        assert "jax" in sys.modules
    finally:
        sys.modules.pop("jax", None)
    out, err = capsys.readouterr()
    assert rc == run.EXIT_FORBIDDEN and not out.strip()
    assert "forbidden modules loaded: ['jax']" in err
