"""The port's homogeneous ``"scanned"`` layout (stacked parameters and
decode state) against the JAX package's, for the four dense homogeneous
configurations (StableLM-1.6B, ChatGLM3-6B, Qwen3-32B, Mistral-Large-123B):
specs, parameters and decode state leaf for leaf; prefill logits, the
stacked decode state and 8 greedy decode steps of the smoke models on
carried-over parameters against ``Model(impl="naive")`` and, on two
configurations, ``Model(impl="pallas")`` (interpret mode), for both of the
port's impls.

Tolerances as in ``tests/test_torch_transformer.py``: 1e-4 for logits,
1e-5 for the decode state (float32 sums in other orders).  One
configuration runs Mistral-Large with a 32-token sliding window over a
48-token prompt, so the prefill ring has wrapped and decode evicts."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as j_base  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.data.synthetic import TokenStream  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

DENSE = ["stablelm-1.6b", "chatglm3-6b", "qwen3-32b", "mistral-large-123b"]
FULL_PARAMS = {"stablelm-1.6b": 1_644_267_520,
               "chatglm3-6b": 6_243_454_976}
B, S, STEPS = 2, 48, 8
LOGIT_TOL = 1e-4
STATE_TOL = 1e-5
SWA = "mistral-large-123b-swa32"
# run name -> (arch, sliding window, also against the JAX pallas route)
RUNS = {"stablelm-1.6b": ("stablelm-1.6b", 0, False),
        "chatglm3-6b": ("chatglm3-6b", 0, True),
        "qwen3-32b": ("qwen3-32b", 0, False),
        "mistral-large-123b": ("mistral-large-123b", 0, False),
        SWA: ("mistral-large-123b", 32, True)}


def _np(x):
    return x.detach().numpy()


def _configs(name):
    arch, window, _ = RUNS[name]
    j, t = j_base.get_config(arch, True), t_base.get_config(arch, True)
    if window:
        j = dataclasses.replace(j, sliding_window=window)
        t = dataclasses.replace(t, sliding_window=window)
    return j, t


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return (tree.shape, tree.init, tree.fan_in)


def _leaves(tree):
    """(leaves as numpy, treedef) of a tree of tensors or JAX arrays."""
    return jax.tree.flatten(jax.tree.map(
        lambda x: _np(x) if isinstance(x, torch.Tensor) else np.asarray(x),
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor)))


# ---------------------------------------------------------------------------
# Specs, parameters, decode state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_scanned_specs_match_reference(arch):
    for smoke in (True, False):
        jm = JModel(j_base.get_config(arch, smoke))
        tm = Model(t_base.get_config(arch, smoke), device="cpu")
        if smoke:
            assert _shapes(tm.param_specs()) == _shapes(jm.param_specs())
        assert tm.num_params() == jm.num_params()
    assert set(tm.param_specs()) == {"embedding", "lm_head", "final_norm",
                                     "scanned"}
    if arch in FULL_PARAMS:
        assert tm.num_params() == FULL_PARAMS[arch]


def test_scanned_init_draws_each_layer_at_its_fan_in():
    """A stacked leaf's ``fan_in`` is the unstacked ``shape[0]`` (``wo``:
    heads x head_dim), so every layer is drawn at its own scale."""
    cfg = t_base.get_config("chatglm3-6b", smoke=True)
    p = Model(cfg, device="cpu").init(0)["scanned"]["attn"]
    # std of N(0, 1) truncated to [-2, 2] is 0.8796
    for leaf, fan_in in ((p["wq"], cfg.d_model),
                         (p["wo"], cfg.num_heads * cfg.resolved_head_dim)):
        assert leaf.shape[0] == cfg.num_layers
        for layer in leaf:
            std = 1 / np.sqrt(fan_in)
            assert float(layer.abs().max()) <= 2 * std
            assert abs(float(layer.std()) / std - 0.8796) < 0.03
    assert not torch.equal(p["wq"][0], p["wq"][1])


@pytest.mark.parametrize("arch", DENSE)
def test_scanned_weights_carry_leaf_for_leaf(arch):
    jp = JModel(j_base.get_config(arch, True)).init(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    j_leaves, j_def = _leaves(jp)
    t_leaves, t_def = _leaves(tp)
    assert t_def == j_def
    for a, b in zip(t_leaves, j_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_scanned_init_decode_state_matches_reference():
    jst = JModel(j_base.get_config("qwen3-32b", True)).init_decode_state(B, 40)
    tst = Model(t_base.get_config("qwen3-32b", True),
                device="cpu").init_decode_state(B, 40)
    j_leaves, j_def = _leaves(jst)
    t_leaves, t_def = _leaves(tst)
    assert t_def == j_def
    for a, b in zip(t_leaves, j_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Prefill + greedy decode of the smoke models
# ---------------------------------------------------------------------------


def _serve(name):
    """Prefill and STEPS decode steps of every route on one set of
    carried-over parameters.  The decode tokens are the first JAX route's
    greedy choices, fed to every route."""
    cfg, tcfg = _configs(name)
    jp = JModel(cfg).init(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    tokens = TokenStream(cfg.vocab_size, seed=0).batch(B, S)["tokens"]
    jax_impls = ["naive"] + (["pallas"] if RUNS[name][2] else [])
    runs, feed = {}, None
    for impl in jax_impls:
        model = JModel(cfg, impl=impl)
        logits, state = jax.jit(model.prefill)(jp, {"tokens": jnp.asarray(
            tokens)})
        runs[f"jax_{impl}"] = {"prefill": logits, "state": state}
        step = jax.jit(model.decode_step)
        if feed is None:
            tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
            feed = []
            for _ in range(STEPS):
                feed.append(np.array(tok))
                lg, state = step(jp, state, tok)
                tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
        state = runs[f"jax_{impl}"]["state"]
        out = []
        for t in feed:
            lg, state = step(jp, state, jnp.asarray(t))
            out.append(np.asarray(lg))
        runs[f"jax_{impl}"]["decode"] = out
    for impl in ("kernel", "naive"):
        model = Model(tcfg, impl=impl, device="cpu")
        logits, state = model.prefill(tp, {"tokens": tokens})
        runs[f"torch_{impl}"] = {"prefill": logits, "state": state}
        before = {k: v.clone() for k, v in state["scanned"].items()}
        out = []
        for t in feed:
            lg, state = model.decode_step(tp, state, torch.from_numpy(t))
            out.append(_np(lg))
        runs[f"torch_{impl}"]["decode"] = out
        # decode left the prefill state as it was
        for k, v in runs[f"torch_{impl}"]["state"]["scanned"].items():
            assert torch.equal(v, before[k]), k
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
def test_scanned_prefill_logits(served, name, jax_impl, torch_impl):
    runs = served(name)
    out = _np(runs[torch_impl]["prefill"])
    ref = np.asarray(runs[jax_impl]["prefill"])
    assert out.shape == ref.shape == (B, 1, 512)
    np.testing.assert_allclose(out, ref, atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("torch_impl", ["torch_kernel", "torch_naive"])
@pytest.mark.parametrize("name", list(RUNS))
def test_scanned_decode_state(served, name, torch_impl):
    runs = served(name)
    t, j = runs[torch_impl]["state"], runs["jax_naive"]["state"]
    assert set(t) == set(j) == {"scanned"}
    t, j = t["scanned"], j["scanned"]
    assert set(t) == set(j) == {"k", "v", "slot_pos", "pos"}
    cfg = _configs(name)[1]
    W = min(cfg.sliding_window or 2 * S, 2 * S)
    assert tuple(t["k"].shape) == (cfg.num_layers, B, W, cfg.num_kv_heads,
                                   cfg.resolved_head_dim)
    assert tuple(t["slot_pos"].shape) == (cfg.num_layers, W)
    for key in j:
        a, b = _np(t[key]), np.asarray(j[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_allclose(a, b, atol=STATE_TOL, rtol=STATE_TOL,
                                   err_msg=key)
    np.testing.assert_array_equal(_np(t["pos"]), [S] * cfg.num_layers)
    if name == SWA:     # wrapped: slot t % 32 holds token t of the last 32
        np.testing.assert_array_equal(
            _np(t["slot_pos"][0]), [S - W + ((s - (S - W)) % W)
                                    for s in range(W)])


@pytest.mark.parametrize("torch_impl", ["torch_kernel", "torch_naive"])
@pytest.mark.parametrize("name,jax_impl", PAIRS)
def test_scanned_greedy_decode_logits(served, name, jax_impl, torch_impl):
    runs = served(name)
    assert len(runs[torch_impl]["decode"]) == STEPS
    for i, (a, b) in enumerate(zip(runs[torch_impl]["decode"],
                                   runs[jax_impl]["decode"])):
        np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                   err_msg=f"decode step {i}")


@pytest.mark.parametrize("impl", ["kernel", "naive"])
def test_scanned_decode_from_empty_state_past_the_ring(impl):
    """Token by token from ``init_decode_state(B, 8)``: 12 steps, so the
    global-attention ring of 8 slots wraps and decode evicts, as in the
    reference."""
    cfg = j_base.get_config("chatglm3-6b", True)
    jp = JModel(cfg).init(jax.random.PRNGKey(1))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    tokens = TokenStream(cfg.vocab_size, seed=3).batch(B, 12)["tokens"]
    jm = JModel(cfg)
    tm = Model(t_base.get_config("chatglm3-6b", True), impl=impl,
               device="cpu")
    jst, tst = jm.init_decode_state(B, 8), tm.init_decode_state(B, 8)
    step = jax.jit(jm.decode_step)
    for i in range(tokens.shape[1]):
        jl, jst = step(jp, jst, jnp.asarray(tokens[:, i:i + 1]))
        tl, tst = tm.decode_step(tp, tst, tokens[:, i:i + 1])
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL, err_msg=f"step {i}")
    np.testing.assert_array_equal(_np(tst["scanned"]["slot_pos"][0]),
                                  [8, 9, 10, 11, 4, 5, 6, 7])
