"""The port's xLSTM cells (``repro_torch.models.recurrent``: mLSTM, its
chunkwise-parallel form, sLSTM), the reference's two-level RG-LRU scan
(``rglru_scan_chunked``), the ``mlstm``/``slstm`` blocks and the xLSTM
smoke model against the JAX package, on the CPU, from the same numpy
inputs and the reference's parameters carried across
(``weights.from_jax_params``); and ``Model(impl="chunked")`` against the
default route, as the reference's own ``test_chunked_impl_parity`` holds
it.

Tolerances: a cell, a block and a scan within 1e-5 of the output's
largest magnitude; prefill logits 1e-4, the decode state 1e-5 (float32
sums in other orders), 8 greedy decode steps the same tokens.  The mLSTM
state starts at m = -1e30, so the first step's forget term must be
exp(-inf) = 0, not NaN.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as j_base  # noqa: E402
from repro.models import recurrent as j_rec  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.data.synthetic import TokenStream  # noqa: E402
from repro_torch.models import recurrent as t_rec  # noqa: E402
from repro_torch.models import transformer as t_tfm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

ARCH = "xlstm-125m"
TOL = 1e-5
LOGIT_TOL = 1e-4
STATE_TOL = 1e-5
B, S, STEPS = 2, 40, 8
FULL_PARAMS = 125_707_824


def _np(x):
    return x.detach().numpy()


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _leaves(tree):
    """(leaves as numpy, treedef) of a tree of tensors or JAX arrays."""
    return jax.tree.flatten(jax.tree.map(
        lambda x: _np(x) if isinstance(x, torch.Tensor) else np.asarray(x),
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor)))


def _hold(got, want, what="", tol=TOL):
    """Every leaf of ``got`` within ``tol`` of ``want``'s largest |value|."""
    g_leaves, g_def = _leaves(got)
    w_leaves, w_def = _leaves(want)
    assert g_def == w_def, what
    for i, (a, b) in enumerate(zip(g_leaves, w_leaves)):
        assert a.shape == b.shape and a.dtype == b.dtype, (what, i)
        assert np.isfinite(a).all(), (what, i)
        err = float(np.abs(a - b).max())
        assert err <= tol * max(float(np.abs(b).max()), 1.0), (what, i, err)


@pytest.fixture(scope="module")
def cell_params():
    """The reference's parameters of xLSTM smoke's two layers (mLSTM,
    sLSTM), numpy."""
    cfg = j_base.get_config(ARCH, True)
    p = JModel(cfg).init(jax.random.PRNGKey(0))
    return cfg, [jax.tree.map(np.asarray, lp["cell"]) for lp in p["layers"]]


def _x(seed, s=S, d=128):
    return np.random.default_rng(seed).normal(size=(B, s, d)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# Specs and states
# ---------------------------------------------------------------------------


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return (tree.shape, tree.init, tree.fan_in)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_xlstm_specs_and_num_params_match_reference(smoke):
    jm = JModel(j_base.get_config(ARCH, smoke))
    tm = Model(t_base.get_config(ARCH, smoke), device="cpu")
    assert _shapes(tm.param_specs()) == _shapes(jm.param_specs())
    assert tm.num_params() == jm.num_params()
    if not smoke:
        assert tm.num_params() == FULL_PARAMS
    for kind, lp in zip(tm.cfg.layer_kinds, tm.param_specs()["layers"]):
        assert set(lp) == {"ln1", "cell"}, kind


def test_xlstm_init_decode_state_matches_reference():
    jst = JModel(j_base.get_config(ARCH, True)).init_decode_state(B, 16)
    tst = Model(t_base.get_config(ARCH, True),
                device="cpu").init_decode_state(B, 16)
    j_leaves, j_def = _leaves(jst)
    t_leaves, t_def = _leaves(tst)
    assert t_def == j_def
    for a, b in zip(t_leaves, j_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert t_rec.mlstm_state_axes() == j_rec.mlstm_state_axes()
    assert t_rec.slstm_state_axes() == j_rec.slstm_state_axes()


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


def test_mlstm_cell_first_step_matches_reference(cell_params):
    cfg = cell_params[0]
    H, hd = cfg.num_heads, cfg.d_model // cfg.num_heads
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(B, H, hd)).astype(np.float32)
               for _ in range(3))
    it, ft = (rng.normal(size=(B, H)).astype(np.float32) for _ in range(2))
    st = j_rec.mlstm_init_state(cfg, B)
    jh, jst = j_rec._mlstm_cell(*map(jnp.asarray, (q, k, v, it, ft)), st)
    th, tst = t_rec._mlstm_cell(*map(_t, (q, k, v, it, ft)),
                                t_rec.mlstm_init_state(cfg, B))
    _hold(th, jh, "h")
    _hold(tst, jst, "state")
    # m = -1e30 at the start: the forget term is exactly 0
    np.testing.assert_array_equal(_np(tst["m"]), it)


@pytest.mark.parametrize("with_state", [False, True])
def test_apply_mlstm_matches_reference(cell_params, with_state):
    cfg, (mp, _) = cell_params
    x = _x(2)
    st = None
    if with_state:
        _, st = j_rec.apply_mlstm(cfg, mp, jnp.asarray(_x(3, 7)))
    jy, jst = j_rec.apply_mlstm(cfg, mp, jnp.asarray(x), st)
    ty, tst = t_rec.apply_mlstm(
        cfg, from_jax_params(mp, device="cpu"), _t(x),
        None if st is None else from_jax_params(jax.tree.map(np.asarray, st),
                                                device="cpu"))
    _hold(ty, jy, "y")
    _hold(tst, jst, "state")


@pytest.mark.parametrize("with_state", [False, True])
def test_apply_slstm_matches_reference(cell_params, with_state):
    cfg, (_, sp) = cell_params
    x = _x(4)
    st = None
    if with_state:
        _, st = j_rec.apply_slstm(cfg, sp, jnp.asarray(_x(5, 7)))
    jy, jst = j_rec.apply_slstm(cfg, sp, jnp.asarray(x), st)
    ty, tst = t_rec.apply_slstm(
        cfg, from_jax_params(sp, device="cpu"), _t(x),
        None if st is None else from_jax_params(jax.tree.map(np.asarray, st),
                                                device="cpu"))
    _hold(ty, jy, "y")
    _hold(tst, jst, "state")


@pytest.mark.parametrize("s,chunk", [(40, 16), (64, 64), (100, 32)])
@pytest.mark.parametrize("with_state", [False, True])
def test_apply_mlstm_chunked_matches_scan_and_reference(cell_params, s,
                                                        chunk, with_state):
    """The chunkwise-parallel form against the port's own scan and
    against the reference's chunked form, with a sequence that is not a
    multiple of the chunk (padded steps) and from a carried state."""
    cfg, (mp, _) = cell_params
    x = _x(6, s)
    tp = from_jax_params(mp, device="cpu")
    st = j_st = None
    if with_state:
        _, j_st = j_rec.apply_mlstm(cfg, mp, jnp.asarray(_x(7, 5)))
        st = from_jax_params(jax.tree.map(np.asarray, j_st), device="cpu")
    ty, tst = t_rec.apply_mlstm_chunked(cfg, tp, _t(x), st, chunk=chunk)
    sy, sst = t_rec.apply_mlstm(cfg, tp, _t(x), st)
    jy, jst = j_rec.apply_mlstm_chunked(cfg, mp, jnp.asarray(x), j_st,
                                        chunk=chunk)
    _hold(ty, jy, "y against the reference's chunked form")
    _hold(tst, jst, "state against the reference's chunked form")
    _hold(ty, sy, "y against the scan")
    _hold({k: v for k, v in tst.items() if k != "m"},
          {k: v for k, v in sst.items() if k != "m"}, "state against the scan")


@pytest.mark.parametrize("s,chunk", [(300, 64), (128, 128), (50, 512)])
def test_rglru_scan_chunked_matches_reference(s, chunk):
    rng = np.random.default_rng(8)
    a = rng.uniform(0.5, 1.0, (2, s, 24)).astype(np.float32)
    b = rng.normal(size=(2, s, 24)).astype(np.float32)
    got = t_rec.rglru_scan_chunked(_t(a), _t(b), chunk=chunk)
    want = np.asarray(jax.jit(j_rec.rglru_scan_chunked, static_argnums=2)(
        jnp.asarray(a), jnp.asarray(b), chunk))
    _hold(got, want)
    _hold(got, np.asarray(jax.jit(j_rec.rglru_scan_ref)(jnp.asarray(a),
                                                        jnp.asarray(b))))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl,j_impl", [("naive", "naive"),
                                         ("chunked", "chunked")])
def test_xlstm_blocks_match_reference(impl, j_impl):
    cfg = j_base.get_config(ARCH, True)
    jp = JModel(cfg).init(jax.random.PRNGKey(1))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    x = _x(9, 70)
    for kind, jl, tl in zip(cfg.layer_kinds, jp["layers"], tp["layers"]):
        jy, jaux = j_tfm.apply_block(cfg, kind, jl, jnp.asarray(x),
                                     impl=j_impl)
        ty, taux = t_tfm.apply_block(t_base.get_config(ARCH, True), kind,
                                     tl, _t(x), impl=impl)
        _hold(ty, jy, kind)
        assert float(taux) == float(jaux) == 0.0
        jy, jst = j_tfm.prefill_block(cfg, kind, jl, jnp.asarray(x),
                                      cache_len=140, dtype=jnp.float32,
                                      impl=j_impl)
        ty, tst = t_tfm.prefill_block(t_base.get_config(ARCH, True), kind,
                                      tl, _t(x), cache_len=140, impl=impl)
        _hold(ty, jy, kind)
        _hold(tst, jst, kind)


# ---------------------------------------------------------------------------
# The xLSTM smoke model: prefill + greedy decode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    """Prefill and STEPS decode steps of the reference's naive and pallas
    routes and the port's kernel, naive and chunked routes on one set of
    carried-over parameters; the decode tokens are the JAX naive route's
    greedy choices, fed to every route."""
    cfg = j_base.get_config(ARCH, True)
    tcfg = t_base.get_config(ARCH, True)
    jp = JModel(cfg).init(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    tokens = TokenStream(cfg.vocab_size, seed=0).batch(B, S)["tokens"]
    runs, feed = {}, None
    for impl in ("naive", "pallas"):
        model = JModel(cfg, impl=impl)
        logits, state = jax.jit(model.prefill)(jp, {"tokens": jnp.asarray(
            tokens)})
        runs[f"jax_{impl}"] = {"prefill": logits, "state": state}
        step = jax.jit(model.decode_step)
        if feed is None:
            feed = [np.array(jnp.argmax(logits[:, -1], -1).astype(
                jnp.int32)[:, None])]
        out = []
        for i in range(STEPS):
            lg, state = step(jp, state, jnp.asarray(feed[i]))
            out.append(np.asarray(lg))
            if len(feed) < STEPS + 1:
                feed.append(np.array(jnp.argmax(lg[:, -1], -1).astype(
                    jnp.int32)[:, None]))
        runs[f"jax_{impl}"]["decode"] = out
    for impl in ("kernel", "naive", "chunked"):
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


T_IMPLS = ["torch_kernel", "torch_naive", "torch_chunked"]


@pytest.mark.parametrize("torch_impl", T_IMPLS)
@pytest.mark.parametrize("jax_impl", ["jax_naive", "jax_pallas"])
def test_xlstm_prefill_logits(served, jax_impl, torch_impl):
    out = _np(served[torch_impl]["prefill"])
    ref = np.asarray(served[jax_impl]["prefill"])
    assert out.shape == ref.shape == (B, 1, 512)
    np.testing.assert_allclose(out, ref, atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("torch_impl", T_IMPLS)
def test_xlstm_decode_state(served, torch_impl):
    t, j = served[torch_impl]["state"], served["jax_naive"]["state"]
    kinds = j_base.get_config(ARCH, True).layer_kinds
    assert len(t["layers"]) == len(j["layers"]) == len(kinds)
    for kind, ts, js in zip(kinds, t["layers"], j["layers"]):
        assert set(ts) == set(js) == ({"C", "n", "m"} if kind == "mlstm"
                                      else {"c", "n", "h", "m"})
        for key in js:
            a, b = _np(ts[key]), np.asarray(js[key])
            assert a.dtype == b.dtype and a.shape == b.shape, key
            np.testing.assert_allclose(a, b, atol=STATE_TOL, rtol=STATE_TOL,
                                       err_msg=f"{kind}.{key}")


@pytest.mark.parametrize("torch_impl", T_IMPLS)
@pytest.mark.parametrize("jax_impl", ["jax_naive", "jax_pallas"])
def test_xlstm_greedy_decode(served, jax_impl, torch_impl):
    for i, (a, b) in enumerate(zip(served[torch_impl]["decode"],
                                   served[jax_impl]["decode"])):
        np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                   err_msg=f"decode step {i}")
    for i, (a, b) in enumerate(zip(served[torch_impl]["tokens"],
                                   served["feed"])):
        np.testing.assert_array_equal(a, b, err_msg=f"token {i}")


def test_xlstm_decode_from_empty_state():
    """Token by token from ``init_decode_state``: the cells' first step
    from m = -1e30."""
    cfg = j_base.get_config(ARCH, True)
    jp = JModel(cfg).init(jax.random.PRNGKey(2))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    tokens = TokenStream(cfg.vocab_size, seed=3).batch(B, 6)["tokens"]
    jm, tm = JModel(cfg), Model(t_base.get_config(ARCH, True), device="cpu")
    jst, tst = jm.init_decode_state(B, 16), tm.init_decode_state(B, 16)
    step = jax.jit(jm.decode_step)
    for i in range(tokens.shape[1]):
        jl, jst = step(jp, jst, jnp.asarray(tokens[:, i:i + 1]))
        tl, tst = tm.decode_step(tp, tst, tokens[:, i:i + 1])
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL, err_msg=f"step {i}")


# ---------------------------------------------------------------------------
# impl="chunked" against the default route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", ARCH])
def test_chunked_impl_matches_default_and_reference(arch):
    """The reference's ``test_chunked_impl_parity``: the chunked route's
    loss against the default route's, here within 1e-5 relative (the
    reference allows 1e-3), and against the reference's chunked loss."""
    cfg = j_base.get_config(arch, True)
    jp = JModel(cfg).init(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    batch = TokenStream(cfg.vocab_size, seed=0).batch(2, 64)
    tcfg = t_base.get_config(arch, True)
    default, _ = Model(tcfg, impl="xla_flash", device="cpu").loss(tp, batch)
    chunked, _ = Model(tcfg, impl="chunked", device="cpu").loss(tp, batch)
    ref, _ = JModel(cfg, impl="chunked").loss(
        jp, jax.tree.map(jnp.asarray, batch))
    assert abs(float(chunked) - float(default)) <= 1e-5 * float(default)
    assert abs(float(chunked) - float(ref)) <= 1e-5 * float(ref)


@pytest.mark.parametrize("impl,calls", [("chunked", 1), ("naive", 0)])
def test_chunked_route_takes_the_chunked_scans(impl, calls, monkeypatch):
    """``impl="chunked"`` runs the mLSTM through ``apply_mlstm_chunked``
    and the RG-LRU through ``rglru_scan_chunked``, once a layer of the
    kind; the other routes never do."""
    seen = {"mlstm": 0, "rglru": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            seen[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(t_rec, "apply_mlstm_chunked",
                        counted("mlstm", t_rec.apply_mlstm_chunked))
    monkeypatch.setattr(t_rec, "rglru_scan_chunked",
                        counted("rglru", t_rec.rglru_scan_chunked))
    for arch, kind in ((ARCH, "mlstm"), ("recurrentgemma-9b", "rglru")):
        cfg = t_base.get_config(arch, True)
        m = Model(cfg, impl=impl, device="cpu")
        m.prefill(m.init(0), {"tokens": np.zeros((1, 12), np.int32)})
        assert seen[kind] == calls * cfg.layer_kinds.count(kind), kind
