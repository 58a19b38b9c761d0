"""bf16 parameters and activations (``Model(param_dtype=, act_dtype=)``)
against the JAX package, on the CPU: every smoke configuration (dense
scanned, MoE, RecurrentGemma, xLSTM, Whisper, InternVL2) at (bf16, bf16),
StableLM's at bf16 parameters and fp32 activations, and RecurrentGemma's
and Whisper's at fp32 parameters and bf16 activations, on the reference's
bf16 (or fp32) parameters carried across bit for bit.  StableLM at fp32
parameters and bf16 activations is refused by both packages: the
reference's ``lax.scan`` over its ``"scanned"`` stack takes no carry that
turns fp32 in a layer, and the port raises there too.

Dtypes are held exactly: every parameter leaf of the port's own init and
of the carried tree, every decode-state leaf after prefill and after 4
teacher-forced decode steps, the loss and every logits tensor have the
reference's dtype (a product of two dtypes computes in the promoted one,
as ``jnp`` does: under fp32 params and bf16 activations the residual
stream turns fp32 at the first layer, as in the reference).

Values are held to BF16_TOL = 3e-2 of each reference output's largest
magnitude (the loss relative).  Why that size: bf16 keeps 8 significant
bits, so one rounding moves a value by up to 2^-9 = 2.0e-3 of it, and the
two packages round at different points (torch's CPU bf16 products
accumulate in fp32 and round once, XLA's may round partial sums; the
reference rounds some intermediates the port keeps, and the reverse).
Through 2-3 layers of norms, attention and MLPs a dozen such roundings
line up at most, ~1-2.5e-2; the largest error measured over these cases
is printed by each test (about 1e-2 on logits).  The reference's
``naive`` route is the oracle; the port runs its ``kernel`` route (the
kernels' plain versions here).

MoE routes are a discrete top-k choice, and in bf16 a rounding-sized move
of a router input flips the ones whose top-k margin is that small; so the
port's routes are pinned to the reference's, and a pick where the two
differ must have a router margin under ROUTE_MARGIN (else it is a real
disagreement and fails).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as j_base  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.data.synthetic import TokenStream  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

from _model_pair import (JAX_DTYPES, assert_runs_close, dtype_name,  # noqa: E402
                         flat, port_run, reference_run, rel_err)

BF16_TOL = 3e-2
ROUTE_MARGIN = 3e-2
B, S, STEPS = 2, 48, 4
BF, F32 = torch.bfloat16, torch.float32
CASES = ([(a, BF, BF) for a in sorted(j_base.ARCH_IDS)]
         + [("stablelm-1.6b", BF, F32), ("recurrentgemma-9b", F32, BF),
            ("whisper-base", F32, BF)])


def _id(case):
    arch, p, a = case
    short = {BF: "bf16", F32: "f32"}
    return f"{arch}-params_{short[p]}-acts_{short[a]}"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg):
    """A training batch (frames or patches for the stub frontends) and the
    teacher-forced decode tokens, from seed 0."""
    d = TokenStream(cfg.vocab_size, seed=0).batch(B, S + STEPS)
    st = S
    batch = {}
    rng = np.random.default_rng(0)
    if cfg.encoder_decoder:
        frames = 128
        st = frames // cfg.decoder_len_ratio
        batch["frames"] = rng.normal(0, 1, (B, frames, cfg.d_model)).astype(
            np.float32)
    elif cfg.frontend == "vision":
        P = cfg.num_prefix_embeds
        st = S - P
        batch["patches"] = rng.normal(0, 1, (B, P, cfg.d_model)).astype(
            np.float32)
    batch["tokens"] = d["tokens"][:, :st]
    batch["targets"] = d["targets"][:, :st]
    feed = [d["tokens"][:, st + i:st + i + 1] for i in range(STEPS)]
    return batch, feed


class _Routes:
    """The reference's MoE routes, recorded in call order from inside its
    jitted runs (an ordered ``jax.debug.callback``), replayed in the same
    order into the port's ``_route``."""

    def __init__(self):
        self.calls, self.flips, self.used = [], 0, 0

    def record(self, monkeypatch):
        orig = j_moe._route

        def rec(cfg, router_w, xt):
            out = orig(cfg, router_w, xt)
            jax.debug.callback(lambda e: self.calls.append(np.asarray(e)),
                               out[1], ordered=True)
            return out
        monkeypatch.setattr(j_moe, "_route", rec)

    def replay(self, monkeypatch):
        orig = t_moe._route

        def rep(cfg, router_w, xt):
            _, own, aux, z = orig(cfg, router_w, xt)
            pinned = torch.tensor(self.calls[self.used]).long()
            self.used += 1
            _, probs = t_moe.router_probs(router_w, xt)
            differ = (torch.sort(own, -1).values
                      != torch.sort(pinned, -1).values).any(-1)
            k = pinned.shape[1]
            srt = torch.sort(probs, -1, descending=True).values
            margins = (srt[:, k - 1] - srt[:, k])[differ]
            assert not margins.numel() or float(margins.max()) < ROUTE_MARGIN
            self.flips += int(differ.sum())
            top_p = torch.gather(probs, 1, pinned)
            top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
            return top_p.to(xt.dtype), pinned, aux, z
        monkeypatch.setattr(t_moe, "_route", rep)


@pytest.fixture(scope="module")
def pair():
    """case -> (port run, reference run), each computed once."""
    cache = {}

    def get(case):
        if case not in cache:
            mp = pytest.MonkeyPatch()
            try:
                cache[case] = _runs(case, mp)
            finally:
                mp.undo()
        return cache[case]
    return get


def _runs(case, monkeypatch):
    arch, pdt, adt = case
    cfg, tcfg = j_base.get_config(arch, True), t_base.get_config(arch, True)
    jp = JModel(cfg, param_dtype=JAX_DTYPES[pdt]).init(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    batch, feed = _batch(cfg)
    routes = _Routes()
    if cfg.is_moe:
        routes.record(monkeypatch)
    ref = reference_run(cfg, "naive", jp, batch, feed,
                        param_dtype=JAX_DTYPES[pdt],
                        act_dtype=JAX_DTYPES[adt])
    if cfg.is_moe:
        routes.replay(monkeypatch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = port_run(tcfg, "kernel", tp, tb, [torch.from_numpy(t) for t in feed],
                   param_dtype=pdt, act_dtype=adt)
    assert routes.used == len(routes.calls)
    return out, ref, jp, tp, routes.flips


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_params_have_the_reference_dtypes(case):
    arch, pdt, _ = case
    cfg, tcfg = j_base.get_config(arch, True), t_base.get_config(arch, True)
    jshapes = flat(JModel(cfg, param_dtype=JAX_DTYPES[pdt]).param_shapes())
    own = flat(Model(tcfg, param_dtype=pdt, device="cpu").init(0))
    metas = flat(Model(tcfg, param_dtype=pdt, device="cpu").param_shapes())
    assert [p for p, _ in own] == [p for p, _ in jshapes]
    for (path, t), (_, m), (_, j) in zip(own, metas, jshapes):
        assert dtype_name(t) == dtype_name(m) == j.dtype.name, path
        assert tuple(t.shape) == tuple(m.shape) == j.shape, path
        assert m.device.type == "meta"


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_outputs_and_states_match_reference(pair, case):
    out, ref, jp, tp, flips = pair(case)
    for (path, a), (_, b) in zip(flat(tp), flat(jp)):
        assert dtype_name(a) == np.asarray(b).dtype.name, path
    errs = [rel_err(out["loss"], ref["loss"]),
            rel_err(out["prefill"], ref["prefill"])] + [
        rel_err(a, b) for a, b in zip(out["decode"], ref["decode"])]
    print(f"{_id(case)}: loss, prefill, decode logits rel err "
          f"{', '.join(f'{e:.2e}' for e in errs)}; MoE picks pinned "
          f"against the port's own: {flips}")
    assert_runs_close(out, ref, BF16_TOL, _id(case))


def test_bf16_activations_give_bf16_outputs_and_state(pair):
    out, ref, *_ = pair(("stablelm-1.6b", BF, BF))
    assert out["prefill"].dtype == BF and out["loss"].dtype == F32
    st = out["state"]["scanned"]
    assert st["k"].dtype == st["v"].dtype == BF
    assert st["pos"].dtype == st["slot_pos"].dtype == torch.int32


def test_fp32_params_and_bf16_activations_turn_fp32_as_the_reference(pair):
    """Under fp32 weights a bf16 embedding meets fp32 products, so the
    residual stream and the logits are fp32; the KV caches stay bf16, the
    conv history is bf16 after prefill (cast there) and fp32 after a
    decode step (the step's fp32 input appended), as in the reference."""
    out, ref, *_ = pair(("recurrentgemma-9b", F32, BF))
    assert out["prefill"].dtype == F32
    assert np.asarray(ref["prefill"]).dtype == np.float32
    assert out["state"]["layers"][2]["k"].dtype == BF
    assert out["state0"]["layers"][0]["conv"].dtype == BF
    assert out["state"]["layers"][0]["conv"].dtype == F32
    assert np.asarray(ref["state"]["layers"][0]["conv"]).dtype == np.float32
    assert out["state"]["layers"][0]["h"].dtype == F32


@pytest.mark.parametrize("what", ["loss", "prefill", "decode"])
def test_scanned_stack_refuses_a_carry_that_turns_fp32_as_the_reference(what):
    """StableLM (the ``"scanned"`` layout) at fp32 parameters and bf16
    activations: the reference's ``lax.scan`` raises ``TypeError``, and so
    does the port."""
    cfg, tcfg = (j_base.get_config("stablelm-1.6b", True),
                 t_base.get_config("stablelm-1.6b", True))
    jm = JModel(cfg, impl="naive", act_dtype=jnp.bfloat16)
    tm = Model(tcfg, act_dtype=BF, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    batch, feed = _batch(cfg)
    calls = {
        "loss": (lambda: jax.jit(jm.loss)(jp, batch),
                 lambda: tm.loss(tp, batch)),
        "prefill": (lambda: jax.jit(jm.prefill)(jp, {"tokens": batch[
                        "tokens"]}),
                    lambda: tm.prefill(tp, {"tokens": batch["tokens"]})),
        "decode": (lambda: jax.jit(jm.decode_step)(
                       jp, jm.init_decode_state(B, 8), feed[0]),
                   lambda: tm.decode_step(tp, tm.init_decode_state(B, 8),
                                          feed[0]))}
    j_call, t_call = calls[what]
    with pytest.raises(TypeError):
        j_call()
    with pytest.raises(TypeError, match="lax.scan"), torch.no_grad():
        t_call()


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "whisper-base"])
def test_from_jax_params_carries_bf16_bit_for_bit(arch):
    cfg = j_base.get_config(arch, True)
    jp = JModel(cfg, param_dtype=jnp.bfloat16).init(jax.random.PRNGKey(3))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    for (path, t), (_, j) in zip(flat(tp), flat(jp)):
        assert t.dtype == BF, path
        bits = np.asarray(j).view(np.int16)
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), bits,
                                      err_msg=str(path))
        # and back: the tensor's bits are a bfloat16 array's again
        back = t.view(torch.int16).numpy().view(np.asarray(j).dtype)
        np.testing.assert_array_equal(back.view(np.int16), bits)


def test_bf16_init_rounds_an_fp32_draw_one_layer_at_a_time():
    """Below fp32 a stacked leaf is drawn a layer at a time: each layer is
    an fp32 truncated normal of the leaf's scale, rounded to bf16."""
    cfg = t_base.get_config("chatglm3-6b", smoke=True)
    cfg = dataclasses.replace(cfg, num_layers=3)
    p = Model(cfg, param_dtype=BF, device="cpu").init(0)
    wq = p["scanned"]["attn"]["wq"]
    assert wq.dtype == BF and wq.shape[0] == 3
    std = 1 / np.sqrt(cfg.d_model)
    for layer in wq.float():
        assert float(layer.abs().max()) <= 2 * std * (1 + 2 ** -8)
        assert abs(float(layer.std()) / std - 0.8796) < 0.03
    assert not torch.equal(wq[0], wq[1])
