"""Multi-pod dry run: cost one rank of every (arch x shape x mesh) pair.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The counterpart of the JAX package's ``repro/launch/dryrun.py``, which
forces 512 placeholder CPU devices, lowers and compiles each pair's step
on the 16x16 (or 2x16x16) production mesh and reads the compiled
program's memory and cost analyses.  The port has no compiler to ask.  It
starts a ``fake`` process group of 256 (or 512) ranks in this one process
(collectives there move nothing), builds the production ``DeviceMesh``
and the model in bf16, makes the ``*_shardings``' arguments as DTensors
of fake tensors (``FakeTensorMode``: shapes and dtypes, no storage; on
the card's device type where there is a card, else on the CPU's), and
runs rank 0's step once on
them under a cost walk (``roofline.cost.CostWalk``), which counts that
rank's FLOPs, bytes and collectives.  A kernel wrapper given fake tensors
launches nothing and hands the walk its launch's cost from shapes
(``kernels.costs.fake_launch``); K7 then counts every ring slot as valid.

Each record has the reference's keys:

* ``memory``: ``argument_bytes`` and ``output_bytes``, this rank's shards
  of the step's arguments and results, exact; ``temp_bytes``, the peak of
  the fake storage made during the step and still alive (what the step
  would hold at once beside its arguments); ``generated_code_bytes`` is
  ``None``: there is no compiled program;
* ``cost``: the walk's ``flops`` and ``bytes_accessed`` (one round trip
  an aten op; ``transcendentals`` are not counted: 0.0);
* ``collectives``: ``roofline.analysis.collective_bytes_from_trace``'s
  keys, the reference's ``collective_bytes_from_hlo``'s;
* ``roofline``: ``roofline_report`` on the H100's peaks;
* ``lower_s``: the seconds to build the model and arguments,
  ``compile_s`` the seconds of the walk.

A pair that does not apply is ``skipped`` with the reference's reason; a
pair that fails is recorded as ``error`` with its traceback, and ``--all``
goes on.  Records go to ``experiments/dryrun_torch/`` (git-ignored), one
JSON a pair.  ``--save-hlo`` is refused: there is no HLO.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist

from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, get_config,
                                      shape_applicable)
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_production_mesh, num_chips
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shd
from repro_torch.roofline.analysis import (collective_bytes_from_trace,
                                           roofline_report)
from repro_torch.roofline.cost import CostWalk

RESULT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "experiments", "dryrun_torch")


@contextlib.contextmanager
def fake_group(world: int):
    """A ``fake`` default process group of ``world`` ranks (this process is
    rank 0), started here if none is initialised and destroyed on leaving;
    an initialised group of that size is used as it is."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"the dry run needs a process group of "
                               f"{world} ranks, the initialised one has "
                               f"{dist.get_world_size()}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


class _LiveBytes:
    """The peak bytes of tensors made inside it and still alive: every
    result of a non-view op is counted until it is freed."""

    def __init__(self):
        self.live = 0
        self.peak = 0
        self._mode = None

    def _made(self, t):
        n = t.numel() * t.element_size()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._freed, n)

    def _freed(self, n):
        self.live -= n

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves
        from repro_torch.roofline import cost as cost_mod
        outer = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if cost_mod._has_dtensor((args, kwargs)):
                    return NotImplemented
                out = func(*args, **kwargs)
                if func.is_view or cost_mod._PAUSED[0]:
                    return out
                ins = {id(t) for t in tree_leaves((args, kwargs))}
                for t in tree_leaves(out):
                    if isinstance(t, torch.Tensor) and id(t) not in ins:
                        outer._made(t)
                return out

        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def local_bytes(tree) -> int:
    """This rank's bytes of a tree of DTensors and tensors."""
    from torch.utils._pytree import tree_leaves
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if shd.is_dtensor(t) else t
            total += t.numel() * t.element_size()
    return total


def _step_and_args(model, shape, rules, microbatches, device,
                   optimizer=None):
    """The step function of ``shape``'s kind and its arguments (DTensors of
    the ``*_shardings``: fake under ``FakeTensorMode``), as the reference
    jits them; a train step with ``optimizer`` (the reference's AdamW by
    default)."""
    if shape.kind == "train":
        optimizer = optimizer or adamw(1e-4)
        step = steps_lib.make_train_step(model, optimizer,
                                         microbatches=microbatches)
        in_sh, shapes = steps_lib.train_shardings(model, optimizer, shape,
                                                  rules)
    elif shape.kind == "prefill":
        in_sh, shapes = steps_lib.prefill_shardings(model, shape, rules)

        def step(params, batch):
            logits, _state = model.prefill(params, batch)
            return logits
    else:
        step = steps_lib.make_serve_step(model)
        in_sh, shapes = steps_lib.decode_shardings(model, shape, rules)
    args = tuple(shd.empty_sharded(s, a, device) for s, a in zip(in_sh,
                                                                   shapes))
    return step, args


def dryrun_step(cfg, shape, mesh, *, rules_name: str = "default",
                impl: str = "xla_flash", microbatches: int = 1,
                param_dtype=torch.bfloat16, act_dtype=torch.bfloat16,
                remat: bool = True, optimizer=None) -> dict:
    """One rank's cost of ``shape``'s step of ``cfg`` on ``mesh`` (a
    ``DeviceMesh`` over an initialised group, fake or real): the record's
    ``memory``, ``cost``, ``collectives`` and ``roofline``, its times and
    the walk's ``kernels``.  The step runs under ``FakeTensorMode``; a
    train step with ``optimizer`` (AdamW by default)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    rules = shd.RULE_SETS[rules_name]
    device = torch.device(mesh.device_type)
    t0 = time.time()
    model = build_model(cfg, mesh=mesh, rules=rules, impl=impl,
                        param_dtype=param_dtype, act_dtype=act_dtype,
                        remat=remat)
    with FakeTensorMode():
        step, args = _step_and_args(model, shape, rules, microbatches,
                                    device, optimizer)
        t_build = time.time() - t0
        t0 = time.time()
        with CostWalk() as walk, _LiveBytes() as live:
            out = step(*args)
        t_walk = time.time() - t0
        mem = {"argument_bytes": local_bytes(args),
               "output_bytes": local_bytes(out),
               "temp_bytes": live.peak,
               "generated_code_bytes": None}
        del out
    cost = walk.result()
    chips = num_chips(mesh)
    rec = {"chips": chips, "lower_s": round(t_build, 2),
           "compile_s": round(t_walk, 2), "memory": mem,
           "cost": {"flops": cost["flops"], "bytes_accessed": cost["bytes"],
                    "transcendentals": 0.0},
           "collectives": collective_bytes_from_trace(cost),
           "kernels": cost["kernels"]}
    rec["roofline"] = roofline_report(cfg, shape, rec, chips,
                                      dtype=act_dtype)
    return rec


def dryrun_pair(arch: str, shape_name: str, *, multi_pod: bool = False,
                rules_name: str = "default", save_hlo: bool = False,
                impl: str = "xla_flash", microbatches: int = 1,
                device=None):
    """Cost one pair on the production mesh; returns the result record
    dict.  ``device`` is the ranks' device type of the fake mesh: by
    default the card's where there is one, else the CPU's (where a kernel
    wrapper's plain version is walked in place of its launch; the
    ``xla_flash`` route launches none)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if save_hlo:
        raise ValueError("--save-hlo: the port compiles no HLO")
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": reason}
    with fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        body = dryrun_step(cfg, shape, mesh, rules_name=rules_name,
                           impl=impl, microbatches=microbatches)
    rec = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
           "rules": rules_name, "impl": impl, "microbatches": microbatches,
           "status": "ok"}
    body.pop("kernels")
    rec.update(body)
    return rec


def _record_path(arch, shape, multi_pod, rules="default", impl="xla_flash",
                 microbatches=1) -> str:
    tag = "{}_{}_{}_{}".format(arch, shape, "mp" if multi_pod else "sp",
                               rules)
    if impl != "xla_flash":
        tag += "_" + impl
    if microbatches > 1:
        tag += f"_mb{microbatches}"
    return os.path.join(RESULT_DIR, tag + ".json")


def save_record(rec):
    os.makedirs(RESULT_DIR, exist_ok=True)
    path = _record_path(rec["arch"], rec["shape"], rec["multi_pod"],
                        rec.get("rules", "default"),
                        rec.get("impl", "xla_flash"),
                        rec.get("microbatches", 1))
    with open(path, "w") as f:
        json.dump(rec, f, indent=2, default=str)


def _error(arch, shape, args, error: str, tb: str) -> dict:
    return {"arch": arch, "shape": shape, "multi_pod": args.multi_pod,
            "rules": args.rules, "status": "error", "error": error,
            "traceback": tb}


def _pair_in_process(arch, shape, args) -> dict:
    """One pair of ``--all`` in a process of its own, cut at
    ``--pair-timeout`` seconds (a python scan over 4,096 positions walks
    for many minutes): its record, or an error record with the reason."""
    import subprocess
    import sys
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--rules", args.rules, "--impl", args.impl,
           "--microbatch", str(args.microbatch)]
    if args.multi_pod:
        cmd.append("--multi-pod")
    path = _record_path(arch, shape, args.multi_pod, args.rules, args.impl,
                        args.microbatch)
    if os.path.exists(path):
        os.remove(path)
    t0 = time.time()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=args.pair_timeout)
    except subprocess.TimeoutExpired:
        return _error(arch, shape, args,
                      f"TimeoutError: the walk took over "
                      f"{args.pair_timeout:g} s (cut at "
                      f"{time.time() - t0:.1f} s)", "")
    if r.returncode not in (0, 1) or not os.path.exists(path):
        return _error(arch, shape, args, f"the pair's process exited with "
                      f"{r.returncode}", r.stderr[-3000:])
    with open(path) as f:
        return json.load(f)


def summary() -> int:
    """The records in RESULT_DIR as a markdown grid, an architecture a row
    and an input shape a column; each pair's cell: per-rank argument and
    temp GB, FLOPs a rank and the dominant roofline term (``ok``), the
    skip, or the error with the walk's seconds."""
    import glob
    recs = {}
    for path in glob.glob(os.path.join(RESULT_DIR, "*.json")):
        with open(path) as f:
            r = json.load(f)
        recs[(r["arch"], r["shape"])] = r
    print("| Arch | " + " | ".join(INPUT_SHAPES) + " |")
    print("| --- |" + " --- |" * len(INPUT_SHAPES))
    for arch in ARCH_IDS:
        cells = []
        for shape in INPUT_SHAPES:
            r = recs.get((arch, shape))
            if r is None:
                cells.append("not run")
            elif r["status"] == "ok":
                m = r["memory"]
                cells.append(f"{m['argument_bytes'] / 1e9:.2f} / "
                             f"{m['temp_bytes'] / 1e9:.1f} GB, "
                             f"{r['cost']['flops']:.3e}, "
                             f"{r['roofline']['dominant'][:-2]}")
            elif r["status"] == "skipped":
                cells.append("skipped: full attention")
            else:
                cells.append(r["error"].split(":")[0] + ": "
                             + r["error"].split(": ", 1)[-1][:48])
        print(f"| {arch} | " + " | ".join(cells) + " |")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--rules", default="default", choices=list(shd.RULE_SETS))
    ap.add_argument("--impl", default="xla_flash")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--save-hlo", action="store_true",
                    help="refused: the port compiles no HLO")
    ap.add_argument("--all", action="store_true", help="full 10x4 matrix")
    ap.add_argument("--summary", action="store_true",
                    help="print a markdown table of the saved records")
    ap.add_argument("--pair-timeout", type=float, default=900.0,
                    help="--all: seconds a pair may take (each runs in a "
                         "process of its own); one that takes longer is "
                         "recorded as an error")
    args = ap.parse_args(argv)
    if args.save_hlo:
        ap.error("--save-hlo: the port compiles no HLO")
    if args.summary:
        return summary()

    if args.all:
        pairs = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        pairs = [(args.arch, args.shape)]

    n_ok = n_skip = n_fail = 0
    for arch, shape in pairs:
        t0 = time.time()
        if args.all:
            rec = _pair_in_process(arch, shape, args)
        else:
            try:
                rec = dryrun_pair(arch, shape, multi_pod=args.multi_pod,
                                  rules_name=args.rules, impl=args.impl,
                                  microbatches=args.microbatch)
            except Exception as e:  # record the failure, keep going
                rec = _error(arch, shape, args, f"{type(e).__name__}: {e}",
                             traceback.format_exc())
        save_record(rec)
        st = rec["status"]
        n_ok += st == "ok"
        n_skip += st == "skipped"
        n_fail += st == "error"
        if st == "ok":
            m = rec["memory"]
            print(f"[OK]   {arch:22s} {shape:12s} "
                  f"walk={rec['compile_s']:7.1f}s "
                  f"temp/dev={(m['temp_bytes'] or 0)/2**30:6.2f}GiB "
                  f"args/dev={(m['argument_bytes'] or 0)/2**30:6.2f}GiB "
                  f"flops={rec['cost']['flops']:.3e} "
                  f"dominant={rec['roofline']['dominant']} "
                  f"wall={time.time() - t0:.1f}s", flush=True)
        elif st == "skipped":
            print(f"[SKIP] {arch:22s} {shape:12s} {rec['reason']}",
                  flush=True)
        else:
            print(f"[FAIL] {arch:22s} {shape:12s} {rec['error']} "
                  f"wall={time.time() - t0:.1f}s", flush=True)
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
