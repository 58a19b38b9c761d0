"""The transformer's training half in the port (``Model.loss``,
``chunked_cross_entropy``, the ``xla_flash`` attention route,
``launch.steps.make_train_step``, ``launch.train``) against the JAX
package, on the CPU, from the same numpy inputs and the reference's
parameters carried across (``weights.from_jax_params``).

Tolerances (ROADMAP's fp32 training tolerance): a loss within 1e-5
relative; each gradient leaf within 1e-5 of that leaf's max|g_ref|.  The
parameters after 3 AdamW steps need more: AdamW's first steps move each
element by about ``lr * sign(g)``, so an element whose gradient is near
rounding moves by up to ``lr`` either way.  Each such leaf is held to 10x
the reference's own spread under a 1e-7 relative move of its init,
measured in the same test (``test_train_step_matches_reference``).

The port's ``xla_flash_attention`` equals dense attention at every length;
the reference's pads the last key block with zeros at position -1e9,
which its causal and bidirectional masks let a query see, so it differs
from dense attention when S > block is not a multiple of the block
(``test_reference_xla_flash_sees_its_key_padding``; never at the
training path's lengths).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as j_base  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import model as j_model  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.data.synthetic import TokenStream  # noqa: E402
from repro_torch.fl.flatten import tree_leaves  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rglru_scan as rs  # noqa: E402
from repro_torch.kernels.grad_guard import refuse_autograd  # noqa: E402
from repro_torch.launch import steps as t_steps  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

REL = 1e-5
SPREAD_NOISE = 1e-7
SPREAD_FACTOR = 10.0
ARCHS = ["stablelm-1.6b", "chatglm3-6b", "recurrentgemma-9b"]
# the configs ported last -> their stub frontend's input
UNPORTED = {"internvl2-26b": "patches", "whisper-base": "frames"}
# the MoE and xLSTM smoke models: ce and aux within 1e-6 relative
AUX_ARCHS = ["qwen2-moe-a2.7b", "mixtral-8x7b", "xlstm-125m"]
CE_REL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().numpy()


def _hold_leaves(t_tree, j_tree, what):
    for i, (a, b) in enumerate(zip(tree_leaves(t_tree),
                                   jax.tree.leaves(j_tree))):
        b = np.asarray(b)
        err = float(np.abs(_np(a) - b).max())
        assert err <= REL * float(np.abs(b).max()), (what, i, err)


# -- chunked cross entropy ---------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_chunked_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(3)
    B, S, D, V, chunk = 2, 37, 16, 50, 16        # S not a multiple of chunk
    h = rng.normal(size=(B, S, D)).astype(np.float32)
    w = (rng.normal(size=(D, V)) / 4).astype(np.float32)
    t = rng.integers(0, V, (B, S)).astype(np.int32)
    m = (rng.uniform(size=(B, S)) < 0.7).astype(np.float32) if masked \
        else None

    def j_fn(hw):
        s, c = j_model.chunked_cross_entropy(
            hw[0], hw[1], jnp.asarray(t),
            None if m is None else jnp.asarray(m), chunk=chunk)
        return s, c

    (j_sum, j_cnt), j_g = jax.value_and_grad(j_fn, has_aux=True)(
        (jnp.asarray(h), jnp.asarray(w)))
    params = {"h": torch.tensor(h), "w": torch.tensor(w)}
    (t_sum, aux), t_g = t_steps.value_and_grad(
        lambda p, _: (lambda s, c: (s, {"count": c}))(
            *t_model.chunked_cross_entropy(
                p["h"], p["w"], torch.tensor(t),
                None if m is None else torch.tensor(m), chunk=chunk)),
        params, None)
    assert float(aux["count"]) == float(j_cnt) == (m.sum() if masked
                                                   else B * S)
    assert abs(float(t_sum) - float(j_sum)) <= REL * abs(float(j_sum))
    _hold_leaves([t_g["h"], t_g["w"]], list(j_g), "grads")


# -- the loss and its gradients ------------------------------------------------

def _pair(arch, remat=True, impl="xla_flash"):
    jc, tc = j_base.get_config(arch, True), t_base.get_config(arch, True)
    jm = j_model.Model(jc, remat=remat)
    params = jm.init(jax.random.PRNGKey(0))
    tm = t_model.Model(tc, impl=impl, remat=remat, device="cpu")
    return jm, params, tm, from_jax_params(
        jax.tree.map(np.asarray, params), device="cpu")


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's params (numpy), batch, loss and grads on ``arch``'s
    smoke config (its default ``remat=True``; remat changes no number)."""
    jm, jp, _, _ = _pair(arch)
    batch = TokenStream(jm.cfg.vocab_size, seed=0).batch(2, 40)
    (loss, aux), g = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, jax.tree.map(jnp.asarray, batch))
    return (jax.tree.map(np.asarray, jp), batch, float(loss),
            float(aux["aux"]), jax.tree.map(np.asarray, g))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, remat):
    params, batch, j_loss, j_aux, j_g = _reference(arch)
    tm = t_model.Model(t_base.get_config(arch, True), impl="xla_flash",
                       remat=remat, device="cpu")
    (t_loss, t_aux), t_g = t_steps.value_and_grad(
        tm.loss, from_jax_params(params, device="cpu"), batch)
    assert abs(float(t_loss) - j_loss) <= REL * j_loss
    assert float(t_aux["aux"]) == j_aux == 0.0
    assert float(t_aux["ce"]) == float(t_loss)
    _hold_leaves(t_g, j_g, f"{arch} grads")


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", AUX_ARCHS)
def test_moe_and_xlstm_loss_and_grads_match_reference(arch, remat):
    """``Model.loss`` adds the MoE layers' aux loss (load balance and z
    loss, summed over the layers): ``ce`` and ``aux`` within 1e-6
    relative, every gradient leaf within 1e-5 of its largest reference
    magnitude, through remat and without."""
    params, batch, j_loss, j_aux, j_g = _reference(arch)
    tm = t_model.Model(t_base.get_config(arch, True), impl="xla_flash",
                       remat=remat, device="cpu")
    (t_loss, t_aux), t_g = t_steps.value_and_grad(
        tm.loss, from_jax_params(params, device="cpu"), batch)
    j_ce = j_loss - j_aux
    assert abs(float(t_aux["ce"]) - j_ce) <= CE_REL * j_ce
    if arch == "xlstm-125m":
        assert float(t_aux["aux"]) == j_aux == 0.0
    else:
        assert j_aux > 0
        assert abs(float(t_aux["aux"]) - j_aux) <= CE_REL * j_aux
    assert float(t_loss) == float(t_aux["ce"] + t_aux["aux"])
    _hold_leaves(t_g, j_g, f"{arch} grads")


def test_moe_aux_through_remat_equals_without():
    """The MoE stack's aux loss and its gradient come through
    ``torch.utils.checkpoint`` unchanged (a block returns (x, aux))."""
    cfg = t_base.get_config("qwen2-moe-a2.7b", True)
    m = t_model.Model(cfg, impl="xla_flash", device="cpu")
    params = m.init(0)
    batch = TokenStream(cfg.vocab_size, seed=2).batch(2, 24)

    def aux_only(p, b):
        _, mets = m.loss(p, b)
        return mets["aux"], mets

    (a0, _), g0 = t_steps.value_and_grad(aux_only, params, batch)
    m.remat = False
    (a1, _), g1 = t_steps.value_and_grad(aux_only, params, batch)
    assert float(a0) == float(a1) > 0
    router = [g["moe"]["router"] for g in (g0["scanned"], g1["scanned"])]
    assert float(router[0].abs().max()) > 0
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g0),
                                                 tree_leaves(g1)))


def test_kernel_route_on_the_cpu_is_the_plain_route():
    """On the CPU ``impl="kernel"`` takes the wrappers' differentiable plain
    versions: the same loss and gradients as ``"xla_flash"`` within the
    fp32 tolerance, through RecurrentGemma's attention and scan."""
    _, _, tm, tp = _pair("recurrentgemma-9b")
    km = t_model.Model(tm.cfg, impl="kernel", device="cpu")
    batch = TokenStream(tm.cfg.vocab_size, seed=1).batch(2, 40)
    (kl, _), kg = t_steps.value_and_grad(km.loss, tp, batch)
    (xl, _), xg = t_steps.value_and_grad(tm.loss, tp, batch)
    assert abs(float(kl) - float(xl)) <= REL * float(xl)
    for a, b in zip(tree_leaves(kg), tree_leaves(xg)):
        assert float((a - b).abs().max()) <= REL * float(b.abs().max())


# -- the xla_flash route -------------------------------------------------------

def _qkv(S, seed=0, H=4, K=2, hd=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(1, S, n, hd)).astype(np.float32)
            for n in (H, K, K)]


@pytest.mark.parametrize("S,block", [(1100, 1024), (100, 64)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40),
                                           (False, 0)])
def test_xla_flash_matches_naive(S, block, causal, window):
    q, k, v = (torch.tensor(x) for x in _qkv(S))
    pos = torch.arange(S, dtype=torch.int32)
    got = t_attn.xla_flash_attention(q, k, v, pos, pos, causal, window,
                                     block=block)
    want = t_attn.naive_attention(q, k, v, pos, pos, causal, window)
    assert float((got - want).abs().max()) <= REL * float(want.abs().max())


@pytest.mark.parametrize("S,block", [(2048, 1024), (128, 64), (40, 64)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40)])
def test_xla_flash_matches_reference(S, block, causal, window):
    q, k, v = _qkv(S, seed=1)
    pos = np.arange(S, dtype=np.int32)
    want = np.asarray(j_attn.xla_flash_attention(
        *map(jnp.asarray, (q, k, v, pos, pos)), causal, window, block=block))
    got = t_attn.xla_flash_attention(
        *map(torch.tensor, (q, k, v, pos, pos)), causal, window, block=block)
    assert float(np.abs(_np(got) - want).max()) <= \
        REL * float(np.abs(want).max())


def test_reference_xla_flash_sees_its_key_padding():
    """A documented divergence: at S = 100 over blocks of 64 the reference
    attends to its 28 zero pad keys under a causal mask; the port's route
    and both dense oracles do not."""
    q, k, v = _qkv(100, seed=2)
    pos = np.arange(100, dtype=np.int32)
    jx = [jnp.asarray(a) for a in (q, k, v, pos, pos)]
    ref_flash = np.asarray(j_attn.xla_flash_attention(*jx, True, 0,
                                                      block=64))
    ref_dense = np.asarray(j_attn.naive_attention(*jx, True, 0))
    got = _np(t_attn.xla_flash_attention(
        *map(torch.tensor, (q, k, v, pos, pos)), True, 0, block=64))
    assert np.abs(ref_flash - ref_dense).max() > 0.1
    assert np.abs(got - ref_dense).max() <= REL * np.abs(ref_dense).max()


@pytest.mark.parametrize("window", [0, 24])
def test_xla_flash_grads_match_naive(window):
    q, k, v = _qkv(100, seed=3)
    pos = torch.arange(100, dtype=torch.int32)
    ps = {"q": torch.tensor(q), "k": torch.tensor(k), "v": torch.tensor(v)}

    def loss(fn):
        return lambda p, _: ((fn(p["q"], p["k"], p["v"], pos, pos, True,
                                 window) ** 2).sum(), {})

    _, g_flash = t_steps.value_and_grad(loss(
        lambda *a: t_attn.xla_flash_attention(*a, block=32)), ps, None)
    _, g_dense = t_steps.value_and_grad(loss(t_attn.naive_attention), ps,
                                        None)
    for name in ps:
        ref = g_dense[name]
        assert float((g_flash[name] - ref).abs().max()) <= \
            REL * float(ref.abs().max()), name


# -- the train step --------------------------------------------------------------

def _j_run(jm, params, steps, mb, batches):
    opt = j_adamw(3e-4)
    state = opt.init(params)
    fn = jax.jit(j_steps.make_train_step(jm, opt, microbatches=mb))
    losses = []
    for b in batches:
        params, state, mets = fn(params, state, jax.tree.map(jnp.asarray, b))
        losses.append(float(mets["loss"]))
    return params, losses


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    jm, jp, tm, tp = _pair("stablelm-1.6b")
    stream = TokenStream(jm.cfg.vocab_size, seed=0)
    batches = [stream.batch(4, 32, step=i) for i in range(3)]
    j_final, j_losses = _j_run(jm, jp, 3, microbatches, batches)
    opt = t_adamw(3e-4)
    state = opt.init(tp)
    step = t_steps.make_train_step(tm, opt, microbatches=microbatches)
    t_losses = []
    for b in batches:
        tp, state, mets = step(tp, state, b)
        t_losses.append(float(mets["loss"]))
    assert int(state["step"]) == 3
    np.testing.assert_allclose(t_losses, j_losses, rtol=REL)
    # the reference's spread: its init moved by 1e-7 relative
    rng = np.random.default_rng(1)
    moved = jax.tree.map(lambda x: x * (1 + SPREAD_NOISE * jnp.asarray(
        rng.normal(size=x.shape), jnp.float32)), jp)
    j_moved, _ = _j_run(jm, moved, 3, microbatches, batches)
    for i, (a, b, c) in enumerate(zip(tree_leaves(tp),
                                      jax.tree.leaves(j_final),
                                      jax.tree.leaves(j_moved))):
        b, c = np.asarray(b), np.asarray(c)
        err = float(np.abs(_np(a) - b).max())
        spread = float(np.abs(c - b).max())
        assert err <= max(REL * float(np.abs(b).max()),
                          SPREAD_FACTOR * spread), (i, err, spread)


def test_train_step_microbatches_average_the_grads():
    """Two microbatches of a batch give the mean of their losses and of
    their gradients: the step's update equals SGD on that mean."""
    from repro_torch.optim import sgd
    _, _, tm, tp = _pair("stablelm-1.6b", remat=False)
    batch = TokenStream(tm.cfg.vocab_size, seed=0).batch(4, 16)
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()}
              for i in range(2)]
    outs = [t_steps.value_and_grad(tm.loss, tp, h) for h in halves]
    want_loss = (outs[0][0][0] + outs[1][0][0]) / 2
    before = [t.clone() for t in tree_leaves(tp)]
    step = t_steps.make_train_step(tm, sgd(1.0), microbatches=2)
    tp, _, mets = step(tp, (), batch)
    assert float(mets["loss"]) == float(want_loss)
    for p0, p1, g0, g1 in zip(before, tree_leaves(tp),
                              tree_leaves(outs[0][1]),
                              tree_leaves(outs[1][1])):
        want = p0 - (g0 + g1) / 2
        assert float((p1 - want).abs().max()) <= \
            1e-6 * max(float(want.abs().max()), 1.0)


# -- the CLI, the specs and the unported configs --------------------------------

def test_train_main_dp_runs_and_learns(capsys):
    out = train.main(["--smoke", "--device", "cpu", "--steps", "3",
                      "--log-every", "1", "--batch", "4", "--seq", "32"])
    losses = out["losses"]
    assert len(losses) == len(out["step_s"]) == 3
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    text = capsys.readouterr().out
    assert "arch=stablelm-1.6b smoke=True params=1.6M" in text
    assert text.count("step ") == 3 and "done: 3 steps" in text
    assert all(t.device.type == "cpu" for t in tree_leaves(out["params"]))


def test_train_main_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--steps", "1"])


@pytest.mark.parametrize("arch", sorted(UNPORTED))
def test_unported_configs_raise_naming_item_14(arch):
    """These configs raised ``NotImplementedError`` naming item 14 until
    their frontends were ported; the training CLI now takes them (frames
    or patches from the step's seed) and its losses are finite."""
    out = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "64"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    model = t_model.Model(t_base.get_config(arch, True), device="cpu")
    assert UNPORTED[arch] in train.batch_for(
        model, TokenStream(model.cfg.vocab_size, seed=0), 2, 64, 0)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_and_axes_match_reference(kind):
    shape = t_base.ShapeConfig("s", 64, 4, kind)
    jm = j_model.Model(j_base.get_config("stablelm-1.6b", True))
    tm = t_model.Model(t_base.get_config("stablelm-1.6b", True),
                       device="cpu")
    js = jm.input_specs(j_base.ShapeConfig("s", 64, 4, kind))
    ts = tm.input_specs(shape)
    assert sorted(ts) == sorted(js)
    for k in js:
        assert ts[k].device.type == "meta"
        assert tuple(ts[k].shape) == js[k].shape
        assert ts[k].dtype == torch.int32 and js[k].dtype == jnp.int32
    assert tm.input_axes(shape) == jm.input_axes(
        j_base.ShapeConfig("s", 64, 4, kind))
    assert tm.axes() == jm.axes()


def test_model_rejects_an_unknown_impl():
    with pytest.raises(ValueError, match="impl"):
        t_model.Model(t_base.get_config("stablelm-1.6b", True),
                      impl="pallas", device="cpu")


# -- the kernels' refusal of autograd ---------------------------------------------

def test_refuse_autograd_rule():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="xla_flash"):
        refuse_autograd("k", x)
    with torch.no_grad():
        refuse_autograd("k", x)
    refuse_autograd("k", torch.ones(3))
    with pytest.raises(RuntimeError, match="torch.func"):
        torch.func.vmap(lambda t: refuse_autograd("k", t) or t)(
            torch.ones(2, 3))


def test_cpu_wrappers_stay_differentiable():
    """On the CPU the wrappers take their plain versions, whose gradients
    are autograd's (no refusal there)."""
    q, k, v = (torch.tensor(x, requires_grad=True) for x in _qkv(20))
    fa.flash_attention(q, k, v, causal=True).sum().backward()
    assert q.grad is not None and float(q.grad.abs().max()) > 0
    a = torch.rand(1, 9, 4, requires_grad=True)
    b = torch.rand(1, 9, 4, requires_grad=True)
    rs.rglru_scan(a, b).sum().backward()
    assert float(a.grad.abs().max()) > 0 and float(b.grad.abs().max()) > 0


def test_apply_stack_remat_changes_no_number():
    cfg = dataclasses.replace(t_base.get_config("chatglm3-6b", True),
                              num_layers=3)
    m = t_model.Model(cfg, impl="xla_flash", device="cpu")
    params = m.init(0)
    batch = TokenStream(cfg.vocab_size, seed=2).batch(2, 24)
    (l0, _), g0 = t_steps.value_and_grad(m.loss, params, batch)
    m.remat = False
    (l1, _), g1 = t_steps.value_and_grad(m.loss, params, batch)
    assert float(l0) == float(l1)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g0),
                                                 tree_leaves(g1)))
