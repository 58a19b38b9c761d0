"""Readings that the limits of ``correct`` are set from.

    python3 portbench/controls/calibrate.py --workload <cell> \
        --seeds 11,12,13 --seconds 30

For each seed, in one process: the cell's set-up and a window of
``--seconds`` as a run makes them, then the numbers its check compares for
the program (the lower reading's samples) and for each of the entry's
``CONTROLS`` put in the program's place (the control: the reference one
precision below the configuration's; for a training cell also its
faults).  One JSON line a seed on standard output.  Runs on the card, at
the cell's own size.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))

import run  # noqa: E402
from harness import runtime  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--controls", default="all",
                   help="comma-separated names of CONTROLS, all or none")
    a = p.parse_args(argv)
    runtime.set_environment()
    import torch
    for seed in [int(s) for s in a.seeds.split(",")]:
        t0 = time.perf_counter()
        args = run.parse(["--workload", a.workload, "--seed", str(seed),
                          "--seconds", str(a.seconds)])
        cell, ctx, entry = run.build_entry(args)
        runtime.set_precision(bool(ctx.config.get("tf32", False)))
        entry.setup()
        rec = entry.window(a.seconds)
        entry.free()
        torch.cuda.empty_cache()
        out = {"seed": seed, "units": rec["units"],
               "program": entry.check()}
        names = (list(entry.CONTROLS) if a.controls == "all" else [] if
                 a.controls == "none" else a.controls.split(","))
        for name in names:
            out[name] = entry.check(**entry.CONTROLS[name])
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del entry
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
