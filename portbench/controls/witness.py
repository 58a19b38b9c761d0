"""A second witness for the serving cells' comparison: the program's
prefill with fp32 activations (the weights the benchmark drew, in bf16),
held to the same reference as its bf16 run.  Where the fp32-activation
run lies far closer to the reference than the bf16 run, the reference
and the program compute the same thing and the bf16 run's gap is its
precision's.

    python3 portbench/controls/witness.py --seed 5 --requests 2
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))

import run  # noqa: E402
from harness import runtime, serving  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="qwen-moe-prefill-4k")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--requests", type=int, default=2)
    a = p.parse_args(argv)
    runtime.set_environment()
    import torch
    args = run.parse(["--workload", a.workload, "--seed", str(a.seed),
                      "--seconds", "1"])
    cell, ctx, entry = run.build_entry(args)
    runtime.set_precision(False)
    entry.setup()
    from repro_torch.models.model import Model
    fp32 = Model(entry.model.cfg, impl="kernel", param_dtype=torch.bfloat16,
                 act_dtype=torch.float32,
                 decode_margin=entry.t["decode_margin"], device=ctx.device)
    gaps = sys.modules[type(entry).__module__].logit_gaps
    for _ in range(a.requests):
        entry._request()
        idx = len(entry.served) - 1
        toks = entry.pool[entry.served[idx][0]]
        with torch.no_grad():
            lg32, state = fp32.prefill(entry.weights, {"tokens": toks})
            del state
            ref = entry.reference_logits(idx)
        e16, g16 = gaps(entry.served[idx][1].float(), ref)
        e32, g32 = gaps(lg32[:, -1].float(), ref)
        print(json.dumps({"seed": a.seed, "request": idx,
                          "bf16": {"logit_err": e16.tolist(),
                                   "token_gap": g16.tolist()},
                          "fp32_act": {"logit_err": e32.tolist(),
                                       "token_gap": g32.tolist()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
