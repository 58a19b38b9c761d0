"""The port's transformer serving path against the JAX package's, on the
same carried-over parameters and numpy inputs: the layers it is built of,
the RG-LRU gates, and RecurrentGemma's smoke configuration as a whole
(prefill logits, the decode state, 8 greedy decode steps), against both
``Model(impl="pallas")`` (interpret mode) and ``Model(impl="naive")``.

Tolerances: 1e-6 for one layer; 1e-4 for the logits of three layers and
1e-5 for the decode state (float32 sums in other orders, S = 160 past the
64-token window so the ring cache wraps)."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as j_base  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import recurrent as j_rec  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.data.synthetic import TokenStream  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import recurrent as t_rec  # noqa: E402
from repro_torch.models import transformer as t_tfm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

ARCH = "recurrentgemma-9b"
B, S, STEPS = 2, 160, 8
LAYER_TOL = 1e-6
LOGIT_TOL = 1e-4
STATE_TOL = 1e-5
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _np(x):
    return x.detach().numpy()


# ---------------------------------------------------------------------------
# Configs, specs, parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", j_base.ARCH_IDS)
def test_configs_are_copies(arch, smoke):
    assert dataclasses.asdict(t_base.get_config(arch, smoke)) == \
        dataclasses.asdict(j_base.get_config(arch, smoke))


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_param_specs_match_reference(smoke):
    cfg = j_base.get_config(ARCH, smoke)
    jm, tm = JModel(cfg), Model(t_base.get_config(ARCH, smoke), device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return (tree.shape, tree.init, tree.fan_in)

    assert shapes(tm.param_specs()) == shapes(jm.param_specs())
    assert tm.num_params() == jm.num_params()
    if not smoke:
        assert tm.num_params() == 8_532_381_696


# the families ported last (their stub frontends) -> a part of their tree
UNPORTED = {"whisper-base": "encoder", "internvl2-26b": "scanned"}


@pytest.mark.parametrize("arch", list(UNPORTED))
def test_unported_families_raise(arch):
    """These families raised ``NotImplementedError`` until their frontends
    and the encoder-decoder were ported: now they build with the
    reference's parameter tree, and no module of the port names the item
    that was left."""
    cfg = t_base.get_config(arch, smoke=True)
    specs = Model(cfg, device="cpu").param_specs()
    assert UNPORTED[arch] in specs
    assert sorted(specs) == sorted(JModel(cfg).param_specs())
    src = os.path.join(SRC, "repro_torch")
    for root, _, files in os.walk(src):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    assert "item 14" not in f.read(), name


def test_model_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(t_base.get_config(ARCH, smoke=True))


def test_init_draws_truncated_normal():
    cfg = t_base.get_config(ARCH, smoke=True)
    m = Model(cfg, device="cpu")
    p = m.init(0)
    again = m.init(torch.Generator().manual_seed(0))
    w = p["layers"][0]["mlp"]["wi"]
    assert torch.equal(w, again["layers"][0]["mlp"]["wi"])
    std = 1 / np.sqrt(cfg.d_model)
    assert float(w.abs().max()) <= 2 * std
    # std of N(0, 1) truncated to [-2, 2] is 0.8796
    assert abs(float(w.std()) / std - 0.8796) < 0.02
    assert torch.equal(p["layers"][0]["rnn"]["lam"],
                       torch.ones(cfg.d_model))


def test_weights_carry_lists_leaf_for_leaf():
    cfg = j_base.get_config(ARCH, smoke=True)
    jp = jax.tree.map(np.asarray, JModel(cfg).init(jax.random.PRNGKey(0)))
    tp = from_jax_params(jp, device="cpu")
    assert isinstance(tp["layers"], list) and len(tp["layers"]) == 3
    j_leaves, j_def = jax.tree.flatten(jp)
    t_leaves, t_def = jax.tree.flatten(jax.tree.map(
        _np, tp, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert t_def == j_def
    for a, b in zip(t_leaves, j_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_apply_norm(norm_type):
    cfg = dataclasses.replace(j_base.get_config(ARCH, smoke=True),
                              norm_type=norm_type)
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (2, 7, cfg.d_model)).astype(np.float32)
    p = {"scale": rng.normal(1, 0.1, cfg.d_model).astype(np.float32),
         "bias": rng.normal(0, 0.1, cfg.d_model).astype(np.float32)}
    out = t_layers.apply_norm(cfg, {k: _t(v) for k, v in p.items()}, _t(x))
    r = j_layers.apply_norm(cfg, {k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x))
    np.testing.assert_allclose(_np(out), np.asarray(r), atol=LAYER_TOL,
                               rtol=LAYER_TOL)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope(fraction):
    cfg = dataclasses.replace(j_base.get_config(ARCH, smoke=True),
                              rope_fraction=fraction)
    rng = np.random.default_rng(1)
    hd = 64
    x = rng.normal(0, 1, (2, 160, 4, hd)).astype(np.float32)
    pos = np.arange(160, dtype=np.int32)
    inv = t_layers.rope_freqs(cfg, hd)
    j_inv = j_layers.rope_freqs(cfg, hd)
    np.testing.assert_array_equal(_np(inv), np.asarray(j_inv))
    out = t_layers.apply_rope(_t(x), _t(pos), inv)
    r = j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), j_inv)
    np.testing.assert_allclose(_np(out), np.asarray(r), atol=LAYER_TOL,
                               rtol=LAYER_TOL)


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_apply_mlp(act):
    """``gelu`` is jax.nn.gelu's default, the tanh approximation."""
    cfg = dataclasses.replace(j_base.get_config(ARCH, smoke=True), act=act)
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 5, cfg.d_model)).astype(np.float32)
    shapes = {k: s.shape for k, s in j_layers.mlp_specs(cfg).items()}
    p = {k: (rng.normal(0, 1, s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in shapes.items()}
    out = t_layers.apply_mlp(cfg, {k: _t(v) for k, v in p.items()}, _t(x))
    r = j_layers.apply_mlp(cfg, {k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x))
    np.testing.assert_allclose(_np(out), np.asarray(r), atol=LAYER_TOL,
                               rtol=LAYER_TOL)


def test_rglru_gates_softplus_past_threshold():
    """``F.softplus`` turns into the identity above 20; ``jax.nn.softplus``
    computes log(1 + exp(x)) throughout.  Λ spans both sides.  ``a`` is
    held to 1e-6.  ``sqrt(1 - a^2)`` turns one ulp of ``a`` near 1 into a
    large relative change, in both packages alike, so the gated input is
    held to 1e-6 relative times that condition number, a^2 / (1 - a^2)."""
    d = 64
    rng = np.random.default_rng(3)
    lam = np.concatenate([np.linspace(-30, 30, d - 4),
                          [19.9, 20.0, 20.1, 50.0]]).astype(np.float32)
    p = {"w_a": rng.normal(0, 0.2, (d, d)), "b_a": rng.normal(0, 0.2, d),
         "w_x": rng.normal(0, 0.2, (d, d)), "b_x": rng.normal(0, 0.2, d)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    p["lam"] = lam
    xi = rng.normal(0, 1, (3, 9, d)).astype(np.float32)
    a, gx = t_rec._rglru_gates({k: _t(v) for k, v in p.items()}, _t(xi))
    ja, jgx = j_rec._rglru_gates({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(xi))
    a, gx, ja, jgx = _np(a), _np(gx), np.asarray(ja), np.asarray(jgx)
    np.testing.assert_allclose(a, ja, atol=LAYER_TOL, rtol=LAYER_TOL)
    cond = 1 + ja.astype(np.float64) ** 2 / np.maximum(1 - ja ** 2.0, 1e-12)
    assert (np.abs(gx - jgx) <= LAYER_TOL * (1 + np.abs(jgx) * cond)).all()
    assert (cond[..., :d // 2] > 1e3).any()    # the ill-conditioned end ran


# ---------------------------------------------------------------------------
# The slice as a whole: smoke RecurrentGemma prefill + greedy decode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke_runs():
    """Prefill and 8 decode steps of both packages and both impls on one
    set of carried-over parameters.  The decode tokens are the JAX pallas
    run's greedy choices, fed to every run."""
    cfg = j_base.get_config(ARCH, smoke=True)
    tcfg = t_base.get_config(ARCH, smoke=True)
    jp = JModel(cfg).init(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    tokens = TokenStream(cfg.vocab_size, seed=0).batch(B, S)["tokens"]
    runs = {}
    for name, model, params in [
            ("jax_pallas", JModel(cfg, impl="pallas"), jp),
            ("jax_naive", JModel(cfg, impl="naive"), jp),
            ("torch_kernel", Model(tcfg, device="cpu"), tp),
            ("torch_naive", Model(tcfg, impl="naive", device="cpu"), tp)]:
        is_jax = name.startswith("jax")
        batch = {"tokens": jnp.asarray(tokens) if is_jax else tokens}
        logits, state = model.prefill(params, batch)
        runs[name] = {"prefill": logits, "state": state}
    step = jax.jit(JModel(cfg, impl="pallas").decode_step)
    tok = jnp.argmax(runs["jax_pallas"]["prefill"][:, -1], -1)
    tok = tok.astype(jnp.int32)[:, None]
    feed = []
    state = runs["jax_pallas"]["state"]
    logits = []
    for _ in range(STEPS):
        feed.append(np.array(tok))
        lg, state = step(jp, state, tok)
        logits.append(np.asarray(lg))
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
    runs["jax_pallas"]["decode"] = logits
    for name in ("torch_kernel", "torch_naive"):
        model = Model(tcfg, impl=name.split("_")[1], device="cpu")
        state = runs[name]["state"]
        logits = []
        for t in feed:
            lg, state = model.decode_step(tp, state, torch.from_numpy(t))
            logits.append(_np(lg))
        runs[name]["decode"] = logits
    return runs


@pytest.mark.parametrize("jax_impl", ["jax_pallas", "jax_naive"])
@pytest.mark.parametrize("torch_impl", ["torch_kernel", "torch_naive"])
def test_smoke_prefill_logits(smoke_runs, torch_impl, jax_impl):
    out = _np(smoke_runs[torch_impl]["prefill"])
    ref = np.asarray(smoke_runs[jax_impl]["prefill"])
    assert out.shape == ref.shape == (B, 1, 512)
    np.testing.assert_allclose(out, ref, atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("torch_impl", ["torch_kernel", "torch_naive"])
def test_smoke_decode_state(smoke_runs, torch_impl):
    t_layers_ = smoke_runs[torch_impl]["state"]["layers"]
    j_layers_ = smoke_runs["jax_pallas"]["state"]["layers"]
    assert len(t_layers_) == len(j_layers_) == 3
    kinds = j_base.get_config(ARCH, smoke=True).layer_kinds
    for kind, t, j in zip(kinds, t_layers_, j_layers_):
        assert set(t) == set(j) == ({"h", "conv"} if kind == "rglru" else
                                    {"k", "v", "slot_pos", "pos"})
        for key in j:
            a, b = _np(t[key]), np.asarray(j[key])
            assert a.dtype == b.dtype and a.shape == b.shape, key
            np.testing.assert_allclose(a, b, atol=STATE_TOL, rtol=STATE_TOL,
                                       err_msg=f"{kind}.{key}")
    ring = t_layers_[2]
    assert ring["k"].shape[1] == 64 and int(ring["pos"]) == S
    # the ring wrapped: slot t % 64 holds token t of the last 64
    np.testing.assert_array_equal(
        _np(ring["slot_pos"]),
        [S - 64 + ((s - (S - 64)) % 64) for s in range(64)])


@pytest.mark.parametrize("torch_impl", ["torch_kernel", "torch_naive"])
def test_smoke_greedy_decode_logits(smoke_runs, torch_impl):
    for i, (a, b) in enumerate(zip(smoke_runs[torch_impl]["decode"],
                                   smoke_runs["jax_pallas"]["decode"])):
        np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                   err_msg=f"decode step {i}")
    assert len(smoke_runs[torch_impl]["decode"]) == STEPS


def test_serve_runs_without_jax():
    """``repro_torch.launch.serve`` imports and serves the smoke model on
    the CPU with JAX made unimportable, and loads nothing of ``repro``:
    RecurrentGemma, then the CLI's default (StableLM-1.6B, the scanned
    layout) with every other flag at its default."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch.launch.serve as serve\n"
        "res = serve.main(['--arch', 'recurrentgemma-9b', '--smoke',\n"
        "                  '--device', 'cpu', '--batch', '1',\n"
        "                  '--prompt-len', '70', '--gen', '3'])\n"
        "assert tuple(res['tokens'].shape) == (1, 3)\n"
        "res = serve.main(['--smoke', '--device', 'cpu'])\n"
        "assert tuple(res['tokens'].shape) == (4, 32)\n"
        "bad = [m for m in sys.modules if m == 'repro' or\n"
        "       m.startswith(('repro.', 'jax.', 'jaxlib'))]\n"
        "assert not bad, bad\n"
        "print('served without jax')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert "served without jax" in out.stdout
    assert "ms/token" in out.stdout


@pytest.fixture(scope="module")
def smoke_params():
    cfg = j_base.get_config(ARCH, smoke=True)
    jp = JModel(cfg).init(jax.random.PRNGKey(1))
    return cfg, jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("impl", ["kernel", "naive"])
def test_smoke_apply_block(smoke_params, impl):
    """The full-sequence blocks (``self_attention``, ``apply_rglru``)
    without the decode state, layer after layer, against the reference's
    ``apply_stack`` with its Pallas kernels."""
    cfg, jp, tp = smoke_params
    tcfg = t_base.get_config(ARCH, smoke=True)
    x = np.random.default_rng(4).normal(0, 1, (B, 96, cfg.d_model)).astype(
        np.float32)
    out = _t(x)
    for kind, lp in zip(tcfg.layer_kinds, tp["layers"]):
        out, aux = t_tfm.apply_block(tcfg, kind, lp, out, impl=impl)
        assert float(aux) == 0.0
    ref, _ = j_tfm.apply_stack(cfg, jp, jnp.asarray(x), impl="pallas",
                               remat=False)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def test_smoke_init_decode_state(smoke_params):
    cfg = smoke_params[0]
    jst = JModel(cfg).init_decode_state(B, 40)
    tst = Model(t_base.get_config(ARCH, smoke=True),
                device="cpu").init_decode_state(B, 40)
    j_leaves, j_def = jax.tree.flatten(jst)
    t_leaves, t_def = jax.tree.flatten(jax.tree.map(
        _np, tst, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert t_def == j_def
    for a, b in zip(t_leaves, j_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, np.asarray(b))


def test_smoke_decode_from_empty_state(smoke_params):
    """Token by token from ``init_decode_state``: the never-written ring
    slots must stay masked."""
    cfg, jp, tp = smoke_params
    tokens = TokenStream(cfg.vocab_size, seed=3).batch(B, 6)["tokens"]
    jm = JModel(cfg)
    tm = Model(t_base.get_config(ARCH, smoke=True), device="cpu")
    jst, tst = jm.init_decode_state(B, 16), tm.init_decode_state(B, 16)
    step = jax.jit(jm.decode_step)
    for i in range(tokens.shape[1]):
        jl, jst = step(jp, jst, jnp.asarray(tokens[:, i:i + 1]))
        tl, tst = tm.decode_step(tp, tst, tokens[:, i:i + 1])
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL, err_msg=f"step {i}")
