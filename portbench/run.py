"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the CUDA devices the cell
asks for.  The run loads, warms up (``setup_s``), measures for
``--seconds`` on the host clock, reads the device's peak memory, frees the
program's state, holds what the timed path produced to the plain
reference, and prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones, read from a
profiled slice of the window), ``device`` and, last, ``compared``: each
number compared with its limit.  Those numbers are also the last lines of
standard error.  With no CUDA device, too few of them, or a forbidden
module loaded, it prints no result and exits with another code than 0.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))

from harness import bench, runtime  # noqa: E402

EXIT_NO_DEVICE = 3
EXIT_FORBIDDEN = 4


@dataclasses.dataclass
class Context:
    cell: str
    config: dict
    traffic: dict
    seed: dict
    device: str
    trace: bool


def merged(base: dict, smoke: bool) -> dict:
    """``base`` with its ``smoke`` section laid over it (a small size for
    the CPU tests), or without that section."""
    out = {k: v for k, v in base.items() if k != "smoke"}
    if not smoke:
        return out
    out = copy.deepcopy(out)
    for k, v in base.get("smoke", {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict) \
                and k != "program":
            out[k] = {**out[k], **v}
        else:
            out[k] = v
    return out


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def limits_of(cell: str, base=HERE) -> dict:
    return bench.load_json(Path(base) / "limits" / f"{cell}.json")["numbers"]


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number that the cell's
    limits file names is finite and at most its limit; a number it names
    that the check did not give is not correct.  The check's other
    readings are not compared."""
    rows, ok = [], bool(limits)
    for name, lim in limits.items():
        value = numbers.get(name)
        good = (value is not None and math.isfinite(value)
                and value <= lim["limit"])
        ok = ok and good
        rows.append((name, value, lim["limit"]))
    return ok, rows


def forbidden(found: list) -> bool:
    """Whether ``found`` names forbidden modules (said on stderr)."""
    if found:
        print(f"no result: forbidden modules loaded: {found}",
              file=sys.stderr)
    return bool(found)


def build_entry(args, device=None, smoke=False, root=None):
    """(cell, context, entry) for the parsed arguments."""
    root = Path(root) if root else bench.REPO
    b = bench.load_benchmark(root)
    cell = bench.resolve(b, args.workload, root / "portbench")
    ctx = Context(cell.name, merged(cell.config, smoke),
                  merged(cell.traffic, smoke), runtime.seed_forms(args.seed),
                  device or "cuda", bool(args.trace))
    mod = bench.load_module(cell.entry_path)
    return cell, ctx, mod.Entry(ctx)


def device_info(ctx, cell) -> dict:
    import torch
    if ctx.device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def main(argv=None, device=None, smoke=False, entry_hook=None,
         root=None) -> int:
    """The run.  ``device="cpu"`` and ``smoke=True`` are for the CPU tests
    alone (the smoke sizes of the files, no device check);
    ``entry_hook(entry)`` lets a test break the timed path underneath."""
    args = parse(argv)
    runtime.set_environment()
    import torch
    cell, ctx, entry = build_entry(args, device, smoke, root)
    if device is None:
        why = runtime.check_chips(cell.chips)
        if why:
            print(f"no result: {why}", file=sys.stderr)
            return EXIT_NO_DEVICE
    runtime.set_precision(bool(ctx.config.get("tf32", False)))
    if entry_hook is not None:
        entry_hook(entry)
    entry.setup()
    sync = torch.cuda.synchronize if ctx.device != "cpu" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - T0
    # what set-up made (the harness's inputs and records among it) is kept
    # out of the collector's scans in the window
    gc.collect()
    gc.freeze()
    rec = entry.window(args.seconds)
    sync()
    rec["setup_s"] = setup_s
    dev = device_info(ctx, cell)
    attempted, failed = entry.attempted_failed(rec)
    entry.free()
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    numbers = entry.check()
    if forbidden(runtime.forbidden_loaded()):
        return EXIT_FORBIDDEN
    base = HERE if root is None else Path(root) / "portbench"
    correct, rows = judge(numbers, limits_of(cell.name, base))
    metrics, out = {}, {}
    if args.trace:
        from harness import trace as tr
        for m in cell.per_layer:
            v = bench.metric_module(m["name"], base).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if rec.get("trace") and rec["trace"].get("kernels"):
            busy, window = tr.busy_window_s(rec["trace"])
            dev.update(busy_s=busy, window_s=window)
            out["breakdown"] = tr.breakdown(rec["trace"])
            print(f"trace: {len(rec['trace']['kernels'])} device operations "
                  f"in {window:.6f} s; the hand-written kernels' launches "
                  f"(count, mean us): {tr.own_kernels(rec['trace'])}",
                  file=sys.stderr)
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": bench.metric_module(
                m["name"], base).value(rec), "unit": m["unit"]}
    notes = {k: v for k, v in numbers.items() if k not in dict(
        (r[0], 0) for r in rows)}
    if notes:
        print(f"readings not compared: {notes}", file=sys.stderr)
    for name, value, limit in rows:
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev, **out,
            "compared": {n: {"value": v, "limit": l} for n, v, l in rows}}
    # the metric readers and the trace's reduction are loaded by now: what
    # they bring in is checked too
    if forbidden(runtime.forbidden_loaded()):
        return EXIT_FORBIDDEN
    sys.stdout.flush()
    print(json.dumps(line))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
