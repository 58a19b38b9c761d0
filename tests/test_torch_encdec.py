"""The port's encoder-decoder stack (Whisper-base's smoke config: 2 encoder
and 2 decoder layers, d_model 128, 4 heads, LayerNorm, GELU, sinusoidal
positions, the ``"audio"`` stub frontend) against the JAX package, on
the CPU, from the same numpy inputs and the reference's parameters
carried across (``weights.from_jax_params``).

Every port impl (``kernel`` takes its kernels' plain versions here,
``xla_flash``, ``naive``) is held to the reference's ``naive``,
``xla_flash`` and Pallas (interpret mode) routes: the training loss within
1e-5 relative; the prefill logits, 8 teacher-forced decode steps' logits
and every decode-state leaf within 1e-5 of each reference leaf's largest
magnitude (float32 sums in other orders), integer leaves and dtypes
exactly.  The encoder runs 256 frames: the reference's Pallas route takes
bidirectional attention only at ``Sk % 128 == 0``, and its ``xla_flash``
route attends to its zero key padding past 1,024 keys unless ``Sk`` is a
multiple of 1,024 (the last test shows it; the port attends to the real
keys only).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as j_base  # noqa: E402
from repro.launch import train as j_train  # noqa: E402
from repro.data.synthetic import TokenStream as JTokenStream  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import model as j_model  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.data.synthetic import TokenStream  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

from _model_pair import (as_np, assert_batches_equal,  # noqa: E402
                         assert_runs_close, assert_trees_close, carried, flat,
                         port_run, reference_cli_batch, reference_run)

ARCH = "whisper-base"
FULL_PARAMS = 97_182_720
B, FRAMES, STEPS = 2, 256, 8
TOL = 1e-5
JAX_IMPLS = ["naive", "xla_flash", "pallas"]
TORCH_IMPLS = ["kernel", "xla_flash", "naive"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return j_base.get_config(ARCH, True), t_base.get_config(ARCH, True)


def _batch(cfg, frames=FRAMES, seed=0):
    """A training batch as ``launch.train.batch_for`` makes it, plus the
    teacher-forced decode tokens."""
    st = frames // cfg.decoder_len_ratio
    d = TokenStream(cfg.vocab_size, seed=seed).batch(B, st + STEPS)
    rng = np.random.default_rng(seed)
    batch = {"frames": rng.normal(0, 1, (B, frames, cfg.d_model)).astype(
                 np.float32),
             "tokens": d["tokens"][:, :st], "targets": d["targets"][:, :st]}
    feed = [d["tokens"][:, st + i:st + i + 1] for i in range(STEPS)]
    return batch, feed


@pytest.fixture(scope="module")
def runs():
    cfg, tcfg = _cfgs()
    jp, tp = carried(cfg)
    batch, feed = _batch(cfg)
    out = {f"jax_{i}": reference_run(cfg, i, jp, batch, feed)
           for i in JAX_IMPLS}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tfeed = [torch.from_numpy(t) for t in feed]
    out.update({f"torch_{i}": port_run(tcfg, i, tp, tb, tfeed)
                for i in TORCH_IMPLS})
    return out


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _specs(tree):
    return [(p, (s.shape, s.axes, s.init, s.fan_in)) for p, s in flat(tree)]


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_param_tree_matches_reference(smoke):
    jm = JModel(j_base.get_config(ARCH, smoke))
    tm = Model(t_base.get_config(ARCH, smoke), device="cpu")
    assert _specs(tm.param_specs()) == _specs(jm.param_specs())
    assert set(tm.param_specs()) == {"embedding", "lm_head", "final_norm",
                                     "encoder", "enc_norm", "decoder"}
    assert tm.num_params() == jm.num_params()
    if not smoke:
        assert tm.num_params() == FULL_PARAMS
    shapes = [(p, tuple(t.shape), str(t.dtype)) for p, t in
              flat(tm.param_shapes())]
    assert shapes == [(p, s.shape, "torch.float32")
                      for p, s in flat(jm.param_shapes())]


def test_weights_carry_leaf_for_leaf():
    jp, tp = carried(_cfgs()[0])
    assert_trees_close(tp, jp, 0.0, "params")


def test_init_matches_reference_dtypes_and_draw():
    """The port's own init: the reference's tree, dtypes and scales."""
    tp = Model(_cfgs()[1], device="cpu").init(0)
    jp = JModel(_cfgs()[0]).init(jax.random.PRNGKey(0))
    assert [p for p, _ in flat(tp)] == [p for p, _ in flat(jp)]
    for (path, a), (_, b) in zip(flat(tp), flat(jp)):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, path
        ratio = float(a.std()) / max(float(np.std(np.asarray(b))), 1e-30)
        assert (a.std() == 0) == (np.std(np.asarray(b)) == 0), path
        if float(a.std()) > 0 and a.numel() > 1000:
            assert abs(ratio - 1) < 0.1, (path, ratio)


# ---------------------------------------------------------------------------
# Loss, prefill, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("torch_impl", TORCH_IMPLS)
@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
def test_loss_prefill_and_decode_match_reference(runs, jax_impl, torch_impl):
    assert_runs_close(runs[f"torch_{torch_impl}"], runs[f"jax_{jax_impl}"],
                      TOL, f"{torch_impl} vs {jax_impl}")


def test_decode_state_layout(runs):
    cfg = _cfgs()[1]
    st = runs["torch_kernel"]["state"]
    assert set(st) == {"cross", "self"}
    assert len(st["cross"]) == len(st["self"]) == cfg.num_layers
    hd = cfg.resolved_head_dim
    assert tuple(st["cross"][0]["k"].shape) == (B, FRAMES, cfg.num_kv_heads,
                                                hd)
    ring = FRAMES // cfg.decoder_len_ratio
    assert tuple(st["self"][0]["k"].shape) == (B, ring, cfg.num_kv_heads, hd)
    # the prefill decoded the first prompt token, then STEPS more
    assert int(st["self"][0]["pos"]) == 1 + STEPS
    np.testing.assert_array_equal(
        as_np(st["self"][1]["slot_pos"])[:1 + STEPS], np.arange(1 + STEPS))


def test_prefill_decodes_the_first_prompt_token_only():
    """A quirk of the reference, copied: an encoder-decoder prefill feeds
    the decoder the prompt's first token alone, so the rest of the prompt
    does not change its logits."""
    tcfg = _cfgs()[1]
    batch, _ = _batch(_cfgs()[0], frames=128)
    model = Model(tcfg, device="cpu")
    params = model.init(0)
    other = dict(batch, tokens=np.concatenate(
        [batch["tokens"][:, :1], batch["tokens"][:, 1:] + 1], 1))
    with torch.no_grad():
        a, _ = model.prefill(params, {k: batch[k] for k in ("frames",
                                                             "tokens")})
        b, _ = model.prefill(params, {k: other[k] for k in ("frames",
                                                             "tokens")})
    assert torch.equal(a, b)


@pytest.mark.parametrize("max_len", [64, 40])
def test_init_decode_state_matches_reference(max_len):
    cfg, tcfg = _cfgs()
    jst = JModel(cfg).init_decode_state(B, max_len)
    tst = Model(tcfg, device="cpu").init_decode_state(B, max_len)
    assert_trees_close(tst, jst, 0.0, "init_decode_state")


def test_sinusoid_at_matches_reference_on_the_device_tensor():
    for pos in (0, 1, 7, 186):
        t = t_model._sinusoid_at(torch.tensor(pos, dtype=torch.int32), 128)
        j = j_model._sinusoid_at(jnp.asarray(pos, jnp.int32), 128)
        np.testing.assert_allclose(as_np(t), as_np(j), atol=1e-6, rtol=0)


def test_decode_step_reads_nothing_back_to_the_host(monkeypatch):
    """The decode step's position stays a device tensor: no ``item``,
    ``tolist`` or Python conversion of a tensor on its way."""
    tcfg = _cfgs()[1]
    model = Model(tcfg, device="cpu")
    params = model.init(0)
    state = model.init_decode_state(B, 64)
    tok = torch.zeros((B, 1), dtype=torch.int32)

    def refuse(*_a, **_k):
        raise AssertionError("a tensor was read back to the host")
    for name in ("item", "tolist", "__int__", "__float__", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    with torch.no_grad():
        model.decode_step(params, state, tok)


# ---------------------------------------------------------------------------
# Inputs: specs, the serving CLI's batch, the training batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_and_axes_match_reference(kind):
    shape = t_base.ShapeConfig("s", 1500, 4, kind)
    jm, tm = JModel(_cfgs()[0]), Model(_cfgs()[1], device="cpu")
    js, ts = jm.input_specs(shape), tm.input_specs(shape)
    assert list(ts) == list(js)
    for k in js:
        assert tuple(ts[k].shape) == js[k].shape, k
        assert str(ts[k].dtype).rsplit(".", 1)[-1] == js[k].dtype.name, k
        assert ts[k].device.type == "meta"
    assert tm.input_axes(shape) == jm.input_axes(shape)


def test_cli_batch_equals_reference(monkeypatch):
    argv = ["--arch", ARCH, "--smoke", "--batch", "3", "--prompt-len", "96",
            "--seed", "5"]
    ref = reference_cli_batch(monkeypatch, argv)
    assert ref["frames"].shape == (3, 96, 128)
    assert ref["tokens"].shape == (3, 12)
    assert_batches_equal(t_serve.serve_batch(_cfgs()[1], 3, 96, 5), ref)


def test_serve_cli_runs_on_the_cpu():
    res = t_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "128", "--gen", "4"])
    tokens = res["tokens"]
    assert tuple(tokens.shape) == (2, 4)
    assert bool(((tokens >= 0) & (tokens < 512)).all())


@pytest.mark.parametrize("step", [0, 3])
def test_batch_for_equals_reference(step):
    cfg, tcfg = _cfgs()
    jb = j_train.batch_for(JModel(cfg), JTokenStream(cfg.vocab_size, seed=0),
                           4, 128, step)
    tb = t_train.batch_for(Model(tcfg, device="cpu"),
                           TokenStream(tcfg.vocab_size, seed=0), 4, 128,
                           step)
    assert tb["frames"].shape == (4, 128, 128)
    assert tb["tokens"].shape == tb["targets"].shape == (4, 16)
    assert_batches_equal(tb, jb)


def test_train_cli_runs_on_the_cpu():
    out = t_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--steps", "3", "--batch", "2", "--seq", "64"])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()


# ---------------------------------------------------------------------------
# The reference's key padding, reached without a causal mask
# ---------------------------------------------------------------------------


def test_reference_xla_flash_attends_to_its_noncausal_key_padding():
    """At 1,100 keys (past one block of 1,024, not a multiple of it) the
    reference's ``xla_flash_attention`` pads k and v with zeros at
    position -1e9, and a bidirectional mask admits them: each row averages
    in 948 zero values.  The port's blocked route attends to the real keys
    only and equals the dense formula; the reference's dense formula
    agrees with the port."""
    rng = np.random.default_rng(0)
    Sq, Sk, H, hd = 24, 1100, 2, 16
    q = rng.normal(0, 1, (1, Sq, H, hd)).astype(np.float32)
    k = rng.normal(0, 1, (1, Sk, H, hd)).astype(np.float32)
    v = rng.normal(0, 1, (1, Sk, H, hd)).astype(np.float32) + 3.0
    qp, kp = np.arange(Sq, dtype=np.int32), np.arange(Sk, dtype=np.int32)
    j_args = [jnp.asarray(a) for a in (q, k, v, qp, kp)]
    t_args = [torch.from_numpy(a) for a in (q, k, v, qp, kp)]
    j_dense = np.asarray(j_attn.naive_attention(*j_args, causal=False))
    j_flash = np.asarray(j_attn.xla_flash_attention(*j_args, causal=False))
    t_flash = as_np(t_attn.xla_flash_attention(*t_args, causal=False))
    t_dense = as_np(t_attn.naive_attention(*t_args, causal=False))
    assert np.abs(j_flash - j_dense).max() > 0.1     # the padding shows
    np.testing.assert_allclose(t_flash, j_dense, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(t_dense, j_dense, atol=1e-5, rtol=1e-5)
