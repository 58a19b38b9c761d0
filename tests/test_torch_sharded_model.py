"""The transformer sharded over a ('data', 'model') mesh of ranks
(``Model(mesh=, rules=)``, ``repro_torch.parallel.sharding``, the MoE's
``shard_map`` bodies) against the JAX package's mesh run.

The reference runs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` on
``make_host_mesh(2, 2)``: each smoke model's parameters and batch placed
by its ``logical_to_sharding``, then the jitted loss and gradients, the
prefill and 4 teacher-forced decode steps.  The port runs the same
parameters (``weights.from_jax_params``' layout, ``distribute_tree``) on 4
gloo ranks on the CPU, one spawn for every case.  Held: the loss, every
gradient leaf, the prefill logits and each decode step's logits within
1e-5 of each output's largest magnitude, and for the MoE the routes,
capacity bins and drops (``_dispatch``'s ``dst`` and ``keep``) of every
data shard and layer of the loss's forward, equal.

The MoE cases run Qwen1.5-MoE's smoke model under the default
(tensor-parallel) rules and ``EXPERT_PARALLEL_RULES``.  At data = 2 every
data shard routes its own tokens, so its capacity comes from the LOCAL
token count; the case ``qwen2-moe-a2.7b/overflow`` (capacity factor 0.5)
overflows its bins, and there the mesh run, held to the reference's mesh
run, differs from a single-device run of the same model (checked below).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import run_ranks  # noqa: E402

SPAWN_TIMEOUT_S = 240
TOL = 1e-5
B, S, P, G = 4, 16, 8, 4                 # batch, train seq, prompt, steps
CASES = {
    "stablelm-1.6b/default": ("stablelm-1.6b", "default", None),
    "stablelm-1.6b/seq_parallel": ("stablelm-1.6b", "seq_parallel", None),
    "recurrentgemma-9b/default": ("recurrentgemma-9b", "default", None),
    "qwen2-moe-a2.7b/default": ("qwen2-moe-a2.7b", "default", None),
    "qwen2-moe-a2.7b/expert_parallel": ("qwen2-moe-a2.7b", "expert_parallel",
                                        None),
    "qwen2-moe-a2.7b/overflow": ("qwen2-moe-a2.7b", "default", 0.5),
}
MOE_CASES = [c for c in CASES if c.startswith("qwen")]

REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json, sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs.base import get_config
    from repro.launch.mesh import make_host_mesh
    from repro.models import moe
    from repro.models.model import Model
    from repro.parallel import sharding as shd
    out_dir, cases = sys.argv[2], json.loads(sys.argv[3])
    B, S, P, G = [int(x) for x in sys.argv[4:8]]
    RULES = {"default": shd.DEFAULT_RULES,
             "expert_parallel": shd.EXPERT_PARALLEL_RULES,
             "seq_parallel": shd.SEQ_PARALLEL_RULES}
    ROUTES, RECORD = [], [False]
    orig = moe._dispatch

    def dispatch(xt, top_e, k, E, C):
        buf, dst, keep = orig(xt, top_e, k, E, C)
        try:
            d = jax.lax.axis_index("data")
            m = jax.lax.axis_index("model")
        except NameError:                   # the decode's MoE: off the mesh
            return buf, dst, keep
        jax.debug.callback(lambda d, m, dst, keep: ROUTES.append(
            (int(d), int(m), np.asarray(dst), np.asarray(keep)))
            if RECORD[0] else None, d, m, dst, keep)
        return buf, dst, keep

    def run(cfg, mesh, rules, tokens, res, prefix):
        m = Model(cfg, mesh=mesh, rules=rules, impl="xla_flash", remat=False)
        params = m.init(jax.random.PRNGKey(0))
        for i, x in enumerate(jax.tree.leaves(params)):
            res[f"init{i}"] = np.asarray(x)
        batch = {"tokens": jnp.asarray(tokens[:, :S]),
                 "targets": jnp.asarray(tokens[:, 1:S + 1])}
        if mesh is not None:
            params = jax.device_put(params, shd.logical_to_sharding(
                mesh, m.axes(), m.param_shapes(), rules))
            batch = jax.device_put(batch, shd.logical_to_sharding(
                mesh, {"tokens": ("batch", "seq"),
                       "targets": ("batch", "seq")}, batch, rules))
        RECORD[0] = True
        (loss, _), grads = jax.jit(jax.value_and_grad(m.loss, has_aux=True))(
            params, batch)
        jax.effects_barrier()
        RECORD[0] = False
        res[prefix + "loss"] = np.asarray(loss)
        for i, g in enumerate(jax.tree.leaves(grads)):
            res[prefix + f"grad{i}"] = np.asarray(g)
        logits, state = jax.jit(m.prefill)(params,
                                          {"tokens": batch["tokens"][:, :P]})
        res[prefix + "prefill"] = np.asarray(logits)
        step = jax.jit(m.decode_step)
        for i in range(G):
            logits, state = step(params, state,
                                 jnp.asarray(tokens[:, P + i:P + i + 1]))
            res[prefix + f"decode{i}"] = np.asarray(logits)

    rng = np.random.default_rng(0)
    for name, (arch, rules_name, cf) in cases.items():
        cfg = get_config(arch, smoke=True)
        if cf is not None:
            cfg = dataclasses.replace(cfg, capacity_factor=cf)
        tokens = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        res = {"tokens": tokens}
        moe._dispatch = dispatch
        ROUTES.clear()
        with make_host_mesh(2, 2) as mesh:
            run(cfg, mesh, RULES[rules_name], tokens, res, "")
        for j, (d, m, dst, keep) in enumerate(ROUTES):
            res[f"route{j}"] = np.array([d, m])
            res[f"dst{j}"], res[f"keep{j}"] = dst, keep
        moe._dispatch = orig
        if cf is not None:                  # the single-device run too
            run(cfg, None, None, tokens, res, "one_")
        np.savez(os.path.join(out_dir, name.replace("/", "_") + ".npz"),
                 **res)
    print("OK")
""")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case_rank(cases: dict, paths: dict):
    """One rank's run of every case: rank 0 returns the gathered outputs
    and every rank its MoE routes (its data index, dst, keep)."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.fl.flatten import tree_flatten, tree_unflatten
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.parallel import sharding as shd
    from repro_torch.weights import from_jax_params
    torch.set_num_threads(1)
    mesh = make_host_mesh(2, 2, device="cpu")
    rank = torch.distributed.get_rank()
    routes, record = [], [False]
    orig = moe._dispatch

    def dispatch(xt, top_e, k, E, C):
        buf, dst, keep = orig(xt, top_e, k, E, C)
        if record[0]:
            routes.append((mesh.get_local_rank("data"), dst.numpy().copy(),
                           keep.numpy().copy()))
        return buf, dst, keep

    moe._dispatch = dispatch
    out = {}
    tok_axes = {"tokens": ("batch", "seq"), "targets": ("batch", "seq")}
    for name, (arch, rules_name, cf) in cases.items():
        z = np.load(paths[name])
        rules = shd.RULE_SETS[rules_name]
        cfg = get_config(arch, smoke=True)
        if cf is not None:
            cfg = dataclasses.replace(cfg, capacity_factor=cf)
        m = Model(cfg, mesh=mesh, rules=rules, impl="xla_flash",
                  remat=False, device="cpu")
        names, _ = tree_flatten(m.param_specs())
        params = from_jax_params(tree_unflatten(
            names, [z[f"init{i}"] for i in range(len(names))]), device="cpu")
        params = shd.distribute_tree(mesh, params, m.axes(), rules)
        tokens = torch.tensor(z["tokens"])
        batch = shd.distribute_tree(mesh, {"tokens": tokens[:, :S],
                                           "targets": tokens[:, 1:S + 1]},
                                    tok_axes, rules)
        routes.clear()
        record[0] = True
        (loss, _), grads = value_and_grad(m.loss, params, batch)
        record[0] = False
        res = {"loss": shd.full(loss).numpy(),
               "grads": [shd.full(g).numpy() for g in
                         tree_flatten(grads)[1]],
               "routes": list(routes)}
        logits, state = m.prefill(params, {"tokens": batch["tokens"][:, :P]})
        res["prefill"] = shd.full(logits).numpy()
        res["decode"] = []
        for i in range(G):
            t = shd.distribute_tree(mesh, {"t": tokens[:, P + i:P + i + 1]},
                                    {"t": ("batch", None)}, rules)["t"]
            logits, state = m.decode_step(params, state, t)
            res["decode"].append(shd.full(logits).numpy())
        if rank != 0:
            res = {"routes": res["routes"]}
        out[name] = res
    moe._dispatch = orig
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference npz paths by case, each rank's outputs)."""
    import json
    out_dir = tmp_path_factory.mktemp("sharded_ref")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    r = subprocess.run([sys.executable, "-c", REFERENCE, src, str(out_dir),
                        json.dumps(CASES), *map(str, (B, S, P, G))],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    paths = {name: str(out_dir / (name.replace("/", "_") + ".npz"))
             for name in CASES}
    ranks = run_ranks(_case_rank, 4, CASES, paths, device="cpu",
                      timeout_s=SPAWN_TIMEOUT_S)
    return paths, ranks


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_run_matches_reference_mesh_run(runs, case):
    paths, ranks = runs
    z, got = np.load(paths[case]), ranks[0][case]
    assert _rel(got["loss"], z["loss"]) <= TOL
    n = sum(k.startswith("grad") for k in z.files)
    assert len(got["grads"]) == n
    for i in range(n):
        assert got["grads"][i].shape == z[f"grad{i}"].shape, (case, i)
        assert _rel(got["grads"][i], z[f"grad{i}"]) <= TOL, (case, i)
    assert _rel(got["prefill"], z["prefill"]) <= TOL
    for i in range(G):
        assert _rel(got["decode"][i], z[f"decode{i}"]) <= TOL, (case, i)


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_routes_bins_and_drops_equal_reference(runs, case):
    """Every data shard's routes, bins and drops, layer by layer, equal
    the reference's (its callbacks of each device, in device order; every
    'model' rank of a data shard routes the same tokens)."""
    paths, ranks = runs
    z = np.load(paths[case])
    n = sum(k.startswith("route") for k in z.files)
    want = {}
    for j in range(n):
        d, m = z[f"route{j}"]
        want.setdefault((int(d), int(m)), []).append(
            (z[f"dst{j}"], z[f"keep{j}"]))
    assert len(want) == 4
    for rank, out in enumerate(ranks):
        d, m = divmod(rank, 2)
        got = out[case]["routes"]
        assert [g[0] for g in got] == [d] * len(got)
        ref = want[(d, m)]
        assert len(got) == len(ref) == 2             # the two MoE layers
        for (_, dst, keep), (rdst, rkeep) in zip(got, ref):
            np.testing.assert_array_equal(dst, rdst)
            np.testing.assert_array_equal(keep, rkeep)
    if case.endswith("overflow"):
        assert not all(k.all() for (_, _, k) in ranks[0][case]["routes"])


def test_overflow_mesh_run_differs_from_single_device(runs):
    """Capacity from the local token count: with bins that overflow, the
    data=2 mesh run drops other picks than one device does, so its loss
    and logits differ from the single-device run's (while matching the
    reference's mesh run, above)."""
    paths, ranks = runs
    z = np.load(paths["qwen2-moe-a2.7b/overflow"])
    got = ranks[0]["qwen2-moe-a2.7b/overflow"]
    assert _rel(got["loss"], z["one_loss"]) > 1e-4
    assert _rel(got["prefill"], z["one_prefill"]) > 1e-3
