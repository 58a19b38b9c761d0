"""The port's vision frontend (InternVL2-26B's smoke config: 16 patch
embeddings, the stub of its InternViT tiles, before the tokens of a
2-layer GQA backbone in the ``"scanned"`` layout) against the JAX
package, on the CPU, from the same numpy inputs and the reference's
parameters carried across (``weights.from_jax_params``).

Every port impl (``kernel`` takes its kernels' plain versions here,
``xla_flash``, ``naive``) is held to the reference's ``naive``,
``xla_flash`` and Pallas (interpret mode) routes: the training loss within
1e-5 relative (its hidden rows ``P-1 ... P-1+St``, the reference's
choice), the prefill logits, 8 teacher-forced decode steps' logits and
every decode-state leaf within 1e-5 of each reference leaf's largest
magnitude, integer leaves and dtypes exactly.  The CLI's and
``batch_for``'s inputs equal the reference's exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import base as j_base  # noqa: E402
from repro.data.synthetic import TokenStream as JTokenStream  # noqa: E402
from repro.launch import train as j_train  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.data.synthetic import TokenStream  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

from _model_pair import (as_np, assert_batches_equal,  # noqa: E402
                         assert_runs_close, assert_trees_close, carried, flat,
                         port_run, reference_cli_batch, reference_run)

ARCH = "internvl2-26b"
FULL_PARAMS = 19_861_260_288
B, S, STEPS = 2, 64, 8
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


def _batch(cfg, seed=0):
    """A training batch of S = P + St positions, as ``batch_for`` makes
    it, plus the teacher-forced decode tokens."""
    P = cfg.num_prefix_embeds
    d = TokenStream(cfg.vocab_size, seed=seed).batch(B, S - P + STEPS)
    rng = np.random.default_rng(seed)
    batch = {"patches": rng.normal(0, 1, (B, P, cfg.d_model)).astype(
                 np.float32),
             "tokens": d["tokens"][:, :S - P],
             "targets": d["targets"][:, :S - P]}
    feed = [d["tokens"][:, S - P + i:S - P + i + 1] for i in range(STEPS)]
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


def _specs(tree):
    return [(p, (s.shape, s.axes, s.init, s.fan_in)) for p, s in flat(tree)]


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_param_tree_matches_reference(smoke):
    jm = JModel(j_base.get_config(ARCH, smoke))
    tm = Model(t_base.get_config(ARCH, smoke), device="cpu")
    assert _specs(tm.param_specs()) == _specs(jm.param_specs())
    assert set(tm.param_specs()) == {"embedding", "lm_head", "final_norm",
                                     "scanned"}
    assert tm.num_params() == jm.num_params()
    if not smoke:
        assert tm.num_params() == FULL_PARAMS


def test_weights_carry_leaf_for_leaf():
    jp, tp = carried(_cfgs()[0])
    assert_trees_close(tp, jp, 0.0, "params")


@pytest.mark.parametrize("torch_impl", TORCH_IMPLS)
@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
def test_loss_prefill_and_decode_match_reference(runs, jax_impl, torch_impl):
    assert_runs_close(runs[f"torch_{torch_impl}"], runs[f"jax_{jax_impl}"],
                      TOL, f"{torch_impl} vs {jax_impl}")


def test_decode_state_covers_patches_and_tokens(runs):
    """The scanned stack's caches hold the patches' and the tokens' keys:
    S = P + St positions, S + S slots (the default ``decode_margin``)."""
    cfg = _cfgs()[1]
    st = runs["torch_kernel"]["state0"]["scanned"]
    assert tuple(st["k"].shape) == (cfg.num_layers, B, 2 * S,
                                    cfg.num_kv_heads, cfg.resolved_head_dim)
    np.testing.assert_array_equal(as_np(st["pos"]), [S] * cfg.num_layers)


@pytest.mark.parametrize("margin", [0, 8])
def test_decode_margin_sizes_the_caches_as_the_reference(margin):
    cfg, tcfg = _cfgs()
    jp, tp = carried(cfg)
    batch, _ = _batch(cfg)
    prompt = {k: batch[k] for k in ("patches", "tokens")}
    _, jst = JModel(cfg, decode_margin=margin).prefill(
        jp, jax.tree.map(np.asarray, prompt))
    with torch.no_grad():
        _, tst = Model(tcfg, decode_margin=margin, device="cpu").prefill(
            tp, prompt)
    assert_trees_close(tst, jst, TOL, f"decode_margin={margin}")


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_and_axes_match_reference(kind):
    shape = t_base.ShapeConfig("s", 4096, 2, kind)
    jm, tm = JModel(_cfgs()[0]), Model(_cfgs()[1], device="cpu")
    js, ts = jm.input_specs(shape), tm.input_specs(shape)
    assert list(ts) == list(js)
    for k in js:
        assert tuple(ts[k].shape) == js[k].shape, k
        assert str(ts[k].dtype).rsplit(".", 1)[-1] == js[k].dtype.name, k
    assert tm.input_axes(shape) == jm.input_axes(shape)


def test_cli_batch_equals_reference(monkeypatch):
    """The serving CLI's batch: the reference's ``main`` stopped at its
    first jitted call, against ``serve_batch``."""
    seen = reference_cli_batch(monkeypatch, [
        "--arch", ARCH, "--smoke", "--batch", "3", "--prompt-len", "80",
        "--seed", "2"])
    assert seen["patches"].shape == (3, 16, 256)
    assert seen["tokens"].shape == (3, 64)
    assert_batches_equal(t_serve.serve_batch(_cfgs()[1], 3, 80, 2), seen)


@pytest.mark.parametrize("step", [0, 5])
def test_batch_for_equals_reference(step):
    cfg, tcfg = _cfgs()
    jb = j_train.batch_for(JModel(cfg), JTokenStream(cfg.vocab_size, seed=0),
                           2, 64, step)
    tb = t_train.batch_for(Model(tcfg, device="cpu"),
                           TokenStream(tcfg.vocab_size, seed=0), 2, 64, step)
    assert sorted(tb) == ["patches", "targets", "tokens"]
    assert_batches_equal(tb, jb)


def test_serve_and_train_clis_run_on_the_cpu():
    res = t_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "40", "--gen", "4"])
    assert tuple(res["tokens"].shape) == (2, 4)
    out = t_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--steps", "2", "--batch", "2", "--seq", "48"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
