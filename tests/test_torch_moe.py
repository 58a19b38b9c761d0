"""The port's MoE FFN (``repro_torch.models.moe``) and the MoE smoke models
(Qwen1.5-MoE-A2.7B and Mixtral-8x7B, the ``"scanned"`` layout) against
the JAX package, on the CPU, from the same numpy inputs and the
reference's parameters carried across (``weights.from_jax_params``).

Routing is a discrete choice, so it is held exactly: ``_capacity``, the
experts each token picks (``top_e``), and the capacity bins each pick
lands in (``dst``) or is dropped from (``keep``), with and without
overflow (a capacity factor of 0.5 drops picks).  A flip would show as a
failed equality whose message names the router margin of the flipped
decisions.  Tolerances: gates and aux losses 1e-6 relative; an MoE block's
output 1e-5 of its largest magnitude (the experts' ``w_gate``/``w_up`` are
drawn at ``1/sqrt(E)``, ``fan_in = shape[0]``, as in the reference, so
routed activations are larger than a dense MLP's); prefill logits 1e-4,
the decode state 1e-5, 8 greedy decode steps the same tokens.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as j_base  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.data.synthetic import TokenStream  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import transformer as t_tfm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

MOE = ["qwen2-moe-a2.7b", "mixtral-8x7b"]
FULL_PARAMS = {"qwen2-moe-a2.7b": 14_315_636_736}
REL = 1e-6
BLOCK_TOL = 1e-5
LOGIT_TOL = 1e-4
STATE_TOL = 1e-5
B, S, STEPS = 2, 80, 8          # S past Mixtral smoke's 64-token window
OVERFLOW_CF = 0.5
# run name -> (arch, capacity factor or None for the config's, also
# against the JAX pallas route)
RUNS = {"qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", None, True),
        "mixtral-8x7b": ("mixtral-8x7b", None, True),
        "qwen2-moe-a2.7b-cf0.5": ("qwen2-moe-a2.7b", OVERFLOW_CF, False)}


def _np(x):
    return x.detach().numpy()


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _configs(arch, cf=None):
    j, t = j_base.get_config(arch, True), t_base.get_config(arch, True)
    if cf is not None:
        j = dataclasses.replace(j, capacity_factor=cf)
        t = dataclasses.replace(t, capacity_factor=cf)
    return j, t


def _moe_params(arch, seed=0):
    """The reference's MoE layer parameters of ``arch``'s smoke config
    (numpy), drawn by its own init."""
    cfg = j_base.get_config(arch, True)
    p = JModel(cfg).init(jax.random.PRNGKey(seed))["scanned"]["moe"]
    return jax.tree.map(lambda x: np.asarray(x[0]), p)


def _flip_report(probs, want, got, k):
    """The router margin (k-th minus (k+1)-th probability) of every token
    whose expert set differs between the two packages."""
    diff = np.nonzero((np.sort(want, -1) != np.sort(got, -1)).any(-1))[0]
    srt = -np.sort(-probs, -1)
    return {int(t): float(srt[t, k - 1] - srt[t, k]) for t in diff}


def _hold_rel(a, b, what):
    a, b = float(a), float(b)
    assert abs(a - b) <= REL * abs(b), (what, a, b)


# ---------------------------------------------------------------------------
# Specs and parameter counts
# ---------------------------------------------------------------------------


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return (tree.shape, tree.init, tree.fan_in)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_specs_and_num_params_match_reference(arch, smoke):
    jm = JModel(j_base.get_config(arch, smoke))
    tm = Model(t_base.get_config(arch, smoke), device="cpu")
    assert _shapes(tm.param_specs()) == _shapes(jm.param_specs())
    assert tm.num_params() == jm.num_params()
    if not smoke and arch in FULL_PARAMS:
        assert tm.num_params() == FULL_PARAMS[arch]
    moe = tm.param_specs()["scanned"]["moe"]
    assert "mlp" not in tm.param_specs()["scanned"]
    assert ("shared" in moe) == (arch == "qwen2-moe-a2.7b")
    # the reference's rule, kept on purpose: fan_in = shape[0] = E
    assert moe["w_gate"].fan_in == tm.cfg.num_experts
    assert moe["w_down"].fan_in == (tm.cfg.moe_d_ff or tm.cfg.d_ff)


@pytest.mark.parametrize("T,E,k,cf", [
    (1, 4, 2, 1.25), (96, 4, 2, 1.25), (96, 4, 2, 0.5), (8192, 60, 4, 1.25),
    (2, 60, 4, 1.25), (8192, 8, 2, 1.25), (160, 8, 2, 1.25), (7, 3, 1, 1.0),
    (1000, 16, 3, 2.0)])
def test_capacity_matches_reference(T, E, k, cf):
    assert t_moe._capacity(T, E, k, cf) == j_moe._capacity(T, E, k, cf)
    if (T, E, k) == (8192, 60, 4):
        assert t_moe._capacity(T, E, k, cf) == 688


def test_apply_moe_on_a_mesh_raises_naming_13c():
    """Once ``apply_moe(mesh=)`` raised, naming ROADMAP item 13c; the item
    is ported, so on a mesh both variants now run (here on a fake 2 x 2
    process group, shapes only; ``tests/test_torch_sharded_model.py``
    holds their values to the reference's mesh run)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.layers import init_tree
    from repro_torch.parallel import sharding as shd
    cfg = t_base.get_config("mixtral-8x7b", True)
    specs = t_moe.moe_specs(cfg)
    params = init_tree(torch.Generator().manual_seed(0), specs)
    axes = {k: v.axes for k, v in specs.items()}
    x = torch.zeros(2, 4, cfg.d_model)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = make_host_mesh(2, 2, device="cpu")
        for rules in (shd.DEFAULT_RULES, shd.EXPERT_PARALLEL_RULES):
            p = shd.distribute_tree(mesh, params, axes, rules)
            dx = shd.distribute_tree(mesh, {"x": x},
                                     {"x": ("batch", "seq", None)}, rules)
            with shd.on_mesh(mesh):
                y, aux = t_moe.apply_moe(cfg, p, dx["x"], mesh=mesh,
                                         rules=rules)
            assert shd.is_dtensor(y) and tuple(y.shape) == tuple(x.shape)
            assert tuple(aux.shape) == ()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Routing and dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE)
def test_route_matches_reference(arch):
    cfg, tcfg = _configs(arch)
    p = _moe_params(arch)
    xt = np.random.default_rng(0).normal(size=(192, cfg.d_model)).astype(
        np.float32)
    jg, je, jaux, jz = j_moe._route(cfg, jnp.asarray(p["router"]),
                                    jnp.asarray(xt))
    tg, te, taux, tz = t_moe._route(tcfg, _t(p["router"]), _t(xt))
    je, te = np.asarray(je), _np(te)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(xt) @ p["router"], -1))
    assert np.array_equal(te, je), _flip_report(
        probs, je, te, cfg.num_experts_per_tok)
    g, jg = _np(tg), np.asarray(jg)
    assert np.abs(g - jg).max() <= REL * np.abs(jg).max()
    np.testing.assert_allclose(g.sum(-1), 1.0, rtol=1e-6)
    _hold_rel(taux, jaux, "aux")
    _hold_rel(tz, jz, "z")


@pytest.mark.parametrize("cf", [2.0, OVERFLOW_CF], ids=["fits", "overflow"])
@pytest.mark.parametrize("arch", MOE)
def test_dispatch_matches_reference(arch, cf):
    """From the same routes: the bins, the dropped picks and the dispatch
    buffer equal exactly.  Every token picks expert 0: at a capacity
    factor of 2 its bin holds exactly T rows, at 0.5 picks are dropped."""
    cfg, tcfg = _configs(arch, cf)
    rng = np.random.default_rng(1)
    T, E, k = 96, cfg.num_experts, cfg.num_experts_per_tok
    xt = rng.normal(size=(T, cfg.d_model)).astype(np.float32)
    # skewed routes: expert 0 is popular, so it overflows first
    top_e = np.stack([rng.permutation(np.r_[0, rng.permutation(
        np.arange(1, E))[:k - 1]]) for _ in range(T)]).astype(np.int32)
    C = j_moe._capacity(T, E, k, cf)
    jbuf, jdst, jkeep = j_moe._dispatch(jnp.asarray(xt), jnp.asarray(top_e),
                                        k, E, C)
    tbuf, tdst, tkeep = t_moe._dispatch(_t(xt), _t(top_e).long(), k, E, C)
    np.testing.assert_array_equal(_np(tkeep), np.asarray(jkeep))
    np.testing.assert_array_equal(_np(tdst), np.asarray(jdst))
    np.testing.assert_array_equal(_np(tbuf)[:E * C], np.asarray(jbuf)[:E * C])
    assert tbuf.shape == (E * C + 1, cfg.d_model)
    if cf == OVERFLOW_CF:
        assert not _np(tkeep).all()
        assert (_np(tdst)[~_np(tkeep)] == E * C).all()
    else:
        assert _np(tkeep).all()


@pytest.mark.parametrize("cf", [None, OVERFLOW_CF], ids=["fits", "overflow"])
@pytest.mark.parametrize("arch", MOE)
def test_apply_moe_matches_reference(arch, cf):
    """The whole FFN (routed experts, and Qwen's shared experts with their
    sigmoid gate) on the same input: output within 1e-5 of its scale, aux
    within 1e-6 relative."""
    cfg, tcfg = _configs(arch, cf)
    p = _moe_params(arch, seed=1)
    x = np.random.default_rng(2).normal(size=(B, 48, cfg.d_model)).astype(
        np.float32)
    jy, jaux = j_moe.apply_moe(cfg, jax.tree.map(jnp.asarray, p),
                               jnp.asarray(x))
    ty, taux = t_moe.apply_moe(tcfg, from_jax_params(p, device="cpu"),
                               _t(x))
    jy = np.asarray(jy)
    assert np.abs(_np(ty) - jy).max() <= BLOCK_TOL * np.abs(jy).max()
    _hold_rel(taux, jaux, "aux")
    assert float(taux) > 0


def test_dropped_picks_add_nothing_and_get_no_gradient():
    """A token whose every pick overflowed has a routed output of exactly
    0 and a gradient of exactly 0 (Mixtral: no shared experts)."""
    cfg = dataclasses.replace(t_base.get_config("mixtral-8x7b", True),
                              capacity_factor=0.25)
    p = from_jax_params(_moe_params("mixtral-8x7b"), device="cpu")
    T = 64
    x = torch.tensor(np.random.default_rng(3).normal(
        size=(1, T, cfg.d_model)).astype(np.float32), requires_grad=True)
    _, top_e, _, _ = t_moe._route(cfg, p["router"], x.detach()[0])
    C = t_moe._capacity(T, cfg.num_experts, cfg.num_experts_per_tok, 0.25)
    _, _, keep = t_moe._dispatch(x.detach()[0], top_e,
                                 cfg.num_experts_per_tok, cfg.num_experts, C)
    gone = ~keep.reshape(T, -1).any(-1)
    assert gone.any() and not gone.all()
    y, _ = t_moe.apply_moe(cfg, p, x)
    y.sum().backward()
    assert float(y.detach()[0, gone].abs().max()) == 0.0
    assert float(x.grad[0, gone].abs().max()) == 0.0
    assert float(x.grad[0, ~gone].abs().max()) > 0


def test_apply_moe_under_vmap_of_grad():
    """``torch.func.vmap(grad)`` over a batch of parameter sets (the HFL
    round's form) equals the loop of ``autograd`` gradients."""
    cfg = dataclasses.replace(t_base.get_config("qwen2-moe-a2.7b", True),
                              capacity_factor=OVERFLOW_CF)
    base = from_jax_params(_moe_params("qwen2-moe-a2.7b"), device="cpu")
    ps = {k: v for k, v in base.items() if k != "shared"}
    stacked = {k: torch.stack([v, v * 1.01]) for k, v in ps.items()}
    x = torch.tensor(np.random.default_rng(4).normal(
        size=(2, 1, 24, cfg.d_model)).astype(np.float32))
    shared = base["shared"]

    def loss(pp, xx):
        y, aux = t_moe.apply_moe(cfg, {**pp, "shared": shared}, xx)
        return (y ** 2).mean() + aux

    got = torch.func.vmap(torch.func.grad(loss))(stacked, x)
    for i in range(2):
        leaves = {k: v[i].clone().requires_grad_() for k, v in
                  stacked.items()}
        want = torch.autograd.grad(loss(leaves, x[i]), list(leaves.values()))
        for name, w in zip(leaves, want):
            assert float((got[name][i] - w).abs().max()) <= \
                1e-6 * float(w.abs().max()), name


# ---------------------------------------------------------------------------
# Routes inside the smoke models, layer by layer
# ---------------------------------------------------------------------------


def _recorded_dispatches(module, monkeypatch):
    """Patch ``module._dispatch`` to record (top_e, dst, keep) per call."""
    calls = []
    orig = module._dispatch

    def rec(xt, top_e, k, E, C):
        buf, dst, keep = orig(xt, top_e, k, E, C)
        calls.append([np.asarray(a.detach().numpy() if isinstance(
            a, torch.Tensor) else a) for a in (top_e, dst, keep)])
        return buf, dst, keep
    monkeypatch.setattr(module, "_dispatch", rec)
    return calls


@pytest.mark.parametrize("name", list(RUNS))
def test_model_routes_match_reference(name, monkeypatch):
    """Both packages' stacks, layer after layer, on one prompt: every MoE
    layer's routes, bins and drops equal exactly (the overflow run drops
    picks)."""
    arch, cf, _ = RUNS[name]
    cfg, tcfg = _configs(arch, cf)
    jp = JModel(cfg).init(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    tokens = TokenStream(cfg.vocab_size, seed=0).batch(B, S)["tokens"]
    j_calls = _recorded_dispatches(j_moe, monkeypatch)
    t_calls = _recorded_dispatches(t_moe, monkeypatch)
    jx = jp["embedding"][jnp.asarray(tokens)]
    tx = tp["embedding"][torch.as_tensor(tokens).long()]
    for i in range(cfg.num_layers):
        jl = jax.tree.map(lambda a: a[i], jp["scanned"])
        jx, _ = j_tfm.apply_block(cfg, "attn", jl, jx, impl="naive")
        tx, _ = t_tfm.apply_block(tcfg, "attn", t_tfm._layer(tp["scanned"], i),
                                  tx, impl="naive")
    assert len(j_calls) == len(t_calls) == cfg.num_layers
    for layer, (j, t) in enumerate(zip(j_calls, t_calls)):
        for what, a, b in zip(("top_e", "dst", "keep"), t, j):
            assert np.array_equal(a, b), (layer, what)
    if cf is not None:
        assert not np.concatenate([t[2] for t in t_calls]).all()


# ---------------------------------------------------------------------------
# Prefill + greedy decode of the smoke models
# ---------------------------------------------------------------------------


def _serve(name):
    """Prefill and STEPS decode steps of every route on one set of
    carried-over parameters.  The decode tokens are the JAX naive route's
    greedy choices, fed to every route."""
    arch, cf, pallas = RUNS[name]
    cfg, tcfg = _configs(arch, cf)
    jp = JModel(cfg).init(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    tokens = TokenStream(cfg.vocab_size, seed=0).batch(B, S)["tokens"]
    runs, feed = {}, None
    for impl in ["naive"] + (["pallas"] if pallas else []):
        model = JModel(cfg, impl=impl)
        logits, state = jax.jit(model.prefill)(jp, {"tokens": jnp.asarray(
            tokens)})
        runs[f"jax_{impl}"] = {"prefill": logits, "state": state}
        step = jax.jit(model.decode_step)
        out, tok = [], jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        if feed is None:
            feed = [np.array(tok)]
        for i in range(STEPS):
            lg, state = step(jp, state, jnp.asarray(feed[i]))
            out.append(np.asarray(lg))
            if len(feed) < STEPS + 1:
                feed.append(np.array(jnp.argmax(lg[:, -1], -1).astype(
                    jnp.int32)[:, None]))
        runs[f"jax_{impl}"]["decode"] = out
    for impl in ("kernel", "naive"):
        model = Model(tcfg, impl=impl, device="cpu")
        logits, state = model.prefill(tp, {"tokens": tokens})
        runs[f"torch_{impl}"] = {"prefill": logits, "state": state}
        out, toks = [], [_np(torch.argmax(logits[:, -1], -1))[:, None]]
        for t in feed[:STEPS]:
            lg, state = model.decode_step(tp, state, torch.from_numpy(t))
            out.append(_np(lg))
            toks.append(_np(torch.argmax(lg[:, -1], -1))[:, None])
        runs[f"torch_{impl}"].update(decode=out, tokens=toks)
    runs["feed"] = feed
    return runs


@pytest.fixture(scope="module")
def served():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _serve(name)
        return cache[name]
    return get


PAIRS = [(name, j) for name, (_, _, pallas) in RUNS.items()
         for j in ["jax_naive"] + (["jax_pallas"] if pallas else [])]


@pytest.mark.parametrize("torch_impl", ["torch_kernel", "torch_naive"])
@pytest.mark.parametrize("name,jax_impl", PAIRS)
def test_moe_prefill_logits(served, name, jax_impl, torch_impl):
    runs = served(name)
    out = _np(runs[torch_impl]["prefill"])
    ref = np.asarray(runs[jax_impl]["prefill"])
    assert out.shape == ref.shape == (B, 1, 512)
    np.testing.assert_allclose(out, ref, atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("torch_impl", ["torch_kernel", "torch_naive"])
@pytest.mark.parametrize("name", list(RUNS))
def test_moe_decode_state(served, name, torch_impl):
    runs = served(name)
    t, j = runs[torch_impl]["state"], runs["jax_naive"]["state"]
    assert set(t) == set(j) == {"scanned"}
    t, j = t["scanned"], j["scanned"]
    assert set(t) == set(j) == {"k", "v", "slot_pos", "pos"}
    cfg = _configs(RUNS[name][0])[1]
    W = min(cfg.sliding_window or 2 * S, 2 * S)
    assert tuple(t["k"].shape) == (cfg.num_layers, B, W, cfg.num_kv_heads,
                                   cfg.resolved_head_dim)
    for key in j:
        a, b = _np(t[key]), np.asarray(j[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_allclose(a, b, atol=STATE_TOL, rtol=STATE_TOL,
                                   err_msg=key)


@pytest.mark.parametrize("torch_impl", ["torch_kernel", "torch_naive"])
@pytest.mark.parametrize("name,jax_impl", PAIRS)
def test_moe_greedy_decode(served, name, jax_impl, torch_impl):
    """8 decode steps: logits within 1e-4 and the same greedy tokens."""
    runs = served(name)
    assert len(runs[torch_impl]["decode"]) == STEPS
    for i, (a, b) in enumerate(zip(runs[torch_impl]["decode"],
                                   runs[jax_impl]["decode"])):
        np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                   err_msg=f"decode step {i}")
    for i, (a, b) in enumerate(zip(runs[torch_impl]["tokens"],
                                   runs["feed"])):
        np.testing.assert_array_equal(a, b, err_msg=f"token {i}")
