"""The port's dry run (``repro_torch.launch.dryrun``) and the cost walk's
per-rank counting on DTensors (``roofline.cost.CostWalk``).

* The per-rank walk: a tensor-parallel pair of products on the fake
  256-rank 16x16 mesh counts ONE rank's FLOPs (4,294,967,296, not the
  whole product's 1,099,511,627,776) and its all-reduce's bytes.
* A record's keys equal the reference's (read from its source:
  ``dryrun_pair``'s record and its ``roofline``).
* At smoke width on a 2x2 mesh, the dry run's per-rank FLOPs and
  collective bytes of the train, prefill and decode steps equal a real
  rank's walk of the same step on 4 gloo ranks, exactly; against the
  reference's ``hlo_cost.analyze`` of its compiled sharded step (4
  placeholder devices) the FLOPs of all three are equal, for Qwen1.5-MoE
  too (its decode's MoE splits the router and expert contractions over
  'data', as GSPMD does).
* The production pair ``stablelm-1.6b x train_4k`` on 16x16 (in a
  subprocess): status ``ok``, its per-rank argument bytes equal the sum of
  the reference's ``NamedSharding.shard_shape`` bytes, and the process
  grows by under 1 GB while it runs (no storage for the model).
* A ``long_500k`` pair of a full-attention architecture is skipped with
  the reference's reason.

Every fake process group is started and destroyed inside its test or
subprocess.
"""
import ast
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (make_host_mesh,  # noqa: E402
                                     make_production_mesh, run_ranks)
from repro_torch.roofline.cost import CostWalk  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCH, B, S = "stablelm-1.6b", 4, 32
KINDS = ("train", "prefill", "decode")


def _env():
    return {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}


def test_walk_hooks_dtensor_sharding_propagation(monkeypatch):
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from repro_torch.roofline import cost
    name = "_propagate_tensor_meta_non_cached"
    with cost._pause_sharding_propagation():
        assert getattr(ShardingPropagator, name)._paused
    assert not hasattr(getattr(ShardingPropagator, name), "_paused")
    monkeypatch.delattr(ShardingPropagator, name)
    with pytest.raises(RuntimeError, match=name):
        with CostWalk():
            pass


def test_walk_counts_one_rank_of_a_tensor_parallel_pair():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device="cpu")

        def dt(local, placements, shape):
            shape = torch.Size(shape)
            stride = tuple(int(np.prod(shape[i + 1:]))
                           for i in range(len(shape)))
            return DTensor.from_local(local, mesh, placements, shape=shape,
                                      stride=stride)
        with FakeTensorMode():
            x = dt(torch.empty(4, 128, 4096), [Shard(0), Replicate()],
                   (64, 128, 4096))
            w1 = dt(torch.empty(4096, 512), [Replicate(), Shard(1)],
                    (4096, 8192))
            w2 = dt(torch.empty(512, 4096), [Replicate(), Shard(0)],
                    (8192, 4096))
            with CostWalk() as walk:
                (x @ w1 @ w2).redistribute(mesh, [Shard(0), Replicate()])
    got = walk.result()
    assert got["flops"] == 4_294_967_296          # 2 x 2*512*4096*512
    assert got["coll_all-reduce"] == 8_388_608    # the rank's (4,128,4096)
    assert got["collective_ops"] == 1


def _reference_record_keys():
    tree = ast.parse(open(os.path.join(SRC, "repro", "launch",
                                       "dryrun.py")).read())
    ok = err = None
    nested = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", None) == "rec" for t in node.targets):
            keys = [k.value for k in node.value.keys]
            if "status" in keys and "chips" in keys:
                ok = set(keys) | {"roofline"}
                nested = {k.value: {kk.value for kk in v.keys}
                          for k, v in zip(node.value.keys, node.value.values)
                          if isinstance(v, ast.Dict)}
            elif "traceback" in keys:
                err = set(keys)
    return ok, nested, err


def test_record_keys_equal_the_reference():
    ok, nested, err = _reference_record_keys()
    rec = dryrun.dryrun_pair("whisper-base", "decode_32k")
    assert rec["status"] == "ok"
    assert set(rec) == ok
    for key, sub in nested.items():
        assert set(rec[key]) == sub, key
    assert rec["memory"]["generated_code_bytes"] is None
    from repro_torch.roofline.analysis import (collective_bytes_from_trace,
                                               roofline_report)
    assert set(rec["collectives"]) == set(collective_bytes_from_trace(
        {"flops": 0.0, "bytes": 0.0, "collective_bytes": 0.0,
         "collective_ops": 0, **{f"coll_{k}": 0.0 for k in
                                 ("all-gather", "all-reduce",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute")}}))
    assert set(rec["roofline"]) == set(roofline_report(
        t_base.get_config("whisper-base"),
        t_base.INPUT_SHAPES["decode_32k"], rec, 256))
    bad = {"arch": "x", "shape": "y", "multi_pod": False, "rules": "default",
           "status": "error", "error": "E", "traceback": "T"}
    assert set(bad) == err          # main()'s error record, as built there


def test_long_500k_of_full_attention_is_skipped_with_the_reference_reason():
    from repro.configs.base import get_config, INPUT_SHAPES, shape_applicable
    rec = dryrun.dryrun_pair("stablelm-1.6b", "long_500k")
    _, reason = shape_applicable(get_config("stablelm-1.6b"),
                                 INPUT_SHAPES["long_500k"])
    assert rec == {"arch": "stablelm-1.6b", "shape": "long_500k",
                   "multi_pod": False, "status": "skipped",
                   "reason": reason}


def test_save_hlo_is_refused():
    with pytest.raises(ValueError, match="HLO"):
        dryrun.dryrun_pair("stablelm-1.6b", "train_4k", save_hlo=True)


# -- smoke width on 2x2: the dry run against a real rank and the reference ---

def _shape(kind):
    return t_base.ShapeConfig(kind, S, B, kind)


def _real_rank():
    """Rank 0's walk of each step on real (zeroed) DTensor arguments."""
    from torch.utils._pytree import tree_leaves
    from repro_torch.models.model import build_model
    from repro_torch.parallel import sharding as shd
    torch.set_num_threads(1)
    mesh = make_host_mesh(2, 2, device="cpu")
    out = {}
    for kind in KINDS:
        m = build_model(t_base.get_config(ARCH, smoke=True), mesh=mesh,
                        rules=shd.DEFAULT_RULES, impl="xla_flash",
                        param_dtype=torch.bfloat16, act_dtype=torch.bfloat16)
        step, args = dryrun._step_and_args(m, _shape(kind), shd.DEFAULT_RULES,
                                           1, torch.device("cpu"))
        for t in tree_leaves(args):
            t.to_local().zero_()
        with CostWalk() as walk:
            step(*args)
        r = walk.result()
        out[kind] = (r["flops"], r["collective_bytes"])
    return out


REFERENCE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, sys.argv[1])
    import jax, jax.numpy as jnp
    from repro.configs.base import ShapeConfig, get_config
    from repro.launch import steps
    from repro.launch.mesh import make_host_mesh
    from repro.models.model import Model
    from repro.optim import adamw
    from repro.parallel import sharding as shd
    from repro.roofline import hlo_cost
    arch, B, S = sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    mesh, rules, out = make_host_mesh(2, 2), shd.DEFAULT_RULES, {}
    m = Model(get_config(arch, smoke=True), mesh=mesh, rules=rules,
              impl="xla_flash", param_dtype=jnp.bfloat16,
              act_dtype=jnp.bfloat16)
    with mesh:
        for kind in ("train", "prefill", "decode"):
            shape = ShapeConfig(kind, S, B, kind)
            if kind == "train":
                opt = adamw(1e-4)
                sh, args = steps.train_shardings(m, opt, shape, rules)
                fn = steps.make_train_step(m, opt)
            elif kind == "prefill":
                sh, args = steps.prefill_shardings(m, shape, rules)
                fn = lambda p, b: m.prefill(p, b)[0]
            else:
                sh, args = steps.decode_shardings(m, shape, rules)
                fn = steps.make_serve_step(m)
            low = jax.jit(fn, in_shardings=sh).lower(*args)
            out[kind] = hlo_cost.analyze(low.compile().as_text())["flops"]
    print(json.dumps(out))
""")


def _reference_hlo(arch):
    """The reference's HLO walk of ``arch``'s sharded steps, running in a
    subprocess: (the process, a function returning its FLOPs by kind)."""
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, SRC, arch,
                             str(B), str(S)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=_env())

    def result():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        return json.loads(out.strip().splitlines()[-1])
    return result


def _dry_runs(cfg):
    with dryrun.fake_group(4):
        mesh = make_host_mesh(2, 2, device="cpu")
        return {kind: dryrun.dryrun_step(cfg, _shape(kind), mesh)
                for kind in KINDS}


def test_dryrun_counts_equal_a_real_rank_and_the_reference_hlo():
    ref = _reference_hlo(ARCH)
    real = run_ranks(_real_rank, 4, device="cpu", timeout_s=240)[0]
    dry = _dry_runs(t_base.get_config(ARCH, smoke=True))
    ref = ref()
    for kind in KINDS:
        rec = dry[kind]
        assert (rec["cost"]["flops"], rec["collectives"]["total"]) == \
            real[kind], kind
        assert rec["cost"]["flops"] == ref[kind], (kind, ref[kind])


def test_moe_dryrun_counts_equal_the_reference_hlo():
    """Qwen1.5-MoE at smoke width on 2 x 2: the train step, the prefill
    and the decode step equal the reference's HLO walk exactly (the shared
    experts' second product goes through ``row_parallel``, whose backward
    is each rank's own slice; the decode's MoE, which routes the whole
    batch on every data rank, splits the router and expert contractions
    over D across 'data', as GSPMD partitions the reference's)."""
    arch = "qwen2-moe-a2.7b"
    ref = _reference_hlo(arch)
    cfg = t_base.get_config(arch, smoke=True)
    dry = _dry_runs(cfg)
    ref = ref()
    for kind in KINDS:
        assert dry[kind]["cost"]["flops"] == ref[kind], (kind, ref)


PRODUCTION = textwrap.dedent("""
    import json, resource, sys
    sys.path.insert(0, sys.argv[1])
    from repro_torch.launch import dryrun
    base = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    rec = dryrun.dryrun_pair("stablelm-1.6b", "train_4k")
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - base
    print(json.dumps({"rec": rec, "grown_kb": grown}, default=str))
""")


def _reference_argument_bytes():
    """The reference's per-device argument bytes of the pair: its
    ``train_shardings`` on an abstract 16x16 mesh, each leaf's
    ``shard_shape`` times its width."""
    import jax
    from jax.sharding import AbstractMesh
    from repro.configs.base import INPUT_SHAPES, get_config
    from repro.launch import steps
    from repro.models.model import Model
    from repro.optim import adamw
    from repro.parallel import sharding as shd
    mesh = AbstractMesh((16, 16), ("data", "model"))
    m = Model(get_config("stablelm-1.6b"), mesh=mesh, rules=shd.DEFAULT_RULES,
              param_dtype=jax.numpy.bfloat16, act_dtype=jax.numpy.bfloat16)
    sh, args = steps.train_shardings(m, adamw(1e-4), INPUT_SHAPES["train_4k"],
                                     shd.DEFAULT_RULES)
    return sum(int(np.prod(s.shard_shape(a.shape))) * a.dtype.itemsize
               for s, a in zip(jax.tree.leaves(sh), jax.tree.leaves(args)))


def test_production_pair_argument_bytes_equal_the_reference():
    r = subprocess.run([sys.executable, "-c", PRODUCTION, SRC],
                       capture_output=True, text=True, timeout=600,
                       env=_env())
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    rec = got["rec"]
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["memory"]["argument_bytes"] == _reference_argument_bytes()
    assert got["grown_kb"] < 1e6                    # under 1 GB resident
    assert rec["cost"]["flops"] > 0 and rec["collectives"]["total"] > 0
