"""The port's K7 (``decode_attention``, one-token attention over the ring KV
cache) against the JAX package's Pallas kernel (``ops.decode_attention``,
in interpret mode as ``tests/test_kernels.py`` runs it on the CPU) and its
``ref.py`` oracle, on the same numpy inputs, within 1e-5; and the port's
``decode_self_attention`` on both routes against the JAX one, on one
carried-over layer with a wrapped ring, within 1e-6."""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as j_base  # noqa: E402
from repro.kernels import ops, ref  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models.layers import init_tree  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

KERNEL_TOL = 1e-5
LAYER_TOL = 1e-6
EMPTY = -(10 ** 9)

# B, W, H, K, hd, pos, window, slot layout
CASES = {
    # tests/test_kernels.py's DECODE_CASES: slots 0..pos written in order
    "gqa_2-256-8-4-64": (2, 256, 8, 4, 64, 100, 0, "prefix"),
    "ragged_1-300-4-2-32": (1, 300, 4, 2, 32, 299, 0, "prefix"),
    "window_2-512-8-8-128": (2, 512, 8, 8, 128, 400, 128, "prefix"),
    "mqa_1-64-4-1-64": (1, 64, 4, 1, 64, 10, 0, "prefix"),
    # tests/test_kernels.py::test_decode_attention_matches_model_decode:
    # pos 40 in 32 slots, which hold tokens 9..40
    "ring_wrapped": (2, 32, 4, 2, 16, 40, 0, "ring"),
    # a wrapped ring under a window that drops its oldest slots
    "ring_window": (2, 48, 8, 2, 32, 100, 40, "ring"),
    # no slot written: every score is NEG_INF, the mean of V over W
    "all_empty": (2, 64, 8, 2, 32, 0, 0, "empty"),
}


def _slot_pos(W, pos, layout):
    if layout == "prefix":
        sp = np.full(W, EMPTY, np.int32)
        sp[:min(pos + 1, W)] = np.arange(min(pos + 1, W))
        return sp
    if layout == "ring":
        sp = np.asarray([pos - ((pos - w) % W) for w in range(W)])
        return np.where(sp >= 0, sp, EMPTY).astype(np.int32)
    return np.full(W, EMPTY, np.int32)


def _inputs(case):
    B, W, H, K, hd, pos, window, layout = case
    rng = np.random.default_rng(W + H + hd)
    q = rng.normal(0, 1, (B, 1, H, hd)).astype(np.float32)
    kc = rng.normal(0, 1, (B, W, K, hd)).astype(np.float32)
    vc = rng.normal(0, 1, (B, W, K, hd)).astype(np.float32)
    return q, kc, vc, _slot_pos(W, pos, layout), pos, window


def _port(q, kc, vc, sp, pos, window):
    out = da.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                              torch.from_numpy(vc), torch.from_numpy(sp),
                              torch.tensor(pos, dtype=torch.int32),
                              window=window)
    return out.numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_kernel_and_ref(name):
    q, kc, vc, sp, pos, window = _inputs(CASES[name])
    out = _port(q, kc, vc, sp, pos, window)
    args = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(sp), pos)
    pallas = np.asarray(ops.decode_attention(*args, window=window))
    oracle = np.asarray(ref.decode_attention_ref(*args, window=window))
    assert out.shape == q.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, pallas, atol=KERNEL_TOL, rtol=KERNEL_TOL)
    np.testing.assert_allclose(out, oracle, atol=KERNEL_TOL, rtol=KERNEL_TOL)
    if name == "all_empty":
        mean = np.repeat(vc.mean(1), q.shape[2] // kc.shape[2], axis=1)
        np.testing.assert_allclose(out[:, 0], mean, atol=KERNEL_TOL)


def test_strided_view_of_a_stacked_cache():
    """k and v as views ``[l]`` of one (L, B, W, 2, K, hd) stack, slot_pos
    and pos as views of their (L, W) and (L,) stacks, as the scanned
    layout hands them to the kernel."""
    L, B, W, H, K, hd, l = 3, 2, 96, 8, 2, 32, 1
    rng = np.random.default_rng(5)
    kv = torch.from_numpy(rng.normal(0, 1, (L, B, W, 2, K, hd)).astype(
        np.float32))
    sp = torch.from_numpy(np.stack([_slot_pos(W, 70 + i, "ring")
                                    for i in range(L)]))
    pos = torch.tensor([70, 71, 72], dtype=torch.int32)
    q = torch.from_numpy(rng.normal(0, 1, (B, 1, H, hd)).astype(np.float32))
    k, v = kv[l, :, :, 0], kv[l, :, :, 1]
    assert not k.is_contiguous() and pos[l].dim() == 0
    out = da.decode_attention(q, k, v, sp[l], pos[l], window=64)
    r = ref.decode_attention_ref(jnp.asarray(q.numpy()),
                                 jnp.asarray(k.contiguous().numpy()),
                                 jnp.asarray(v.contiguous().numpy()),
                                 jnp.asarray(sp[l].numpy()), 71, window=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(r), atol=KERNEL_TOL,
                               rtol=KERNEL_TOL)


def test_wrapper_checks_its_arguments():
    q = torch.zeros(1, 1, 4, 8)
    kc = torch.zeros(1, 16, 2, 8)
    sp = torch.zeros(16, dtype=torch.int32)
    pos = torch.tensor(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="0-d int32"):
        da.decode_attention(q, kc, kc, sp, pos.long())
    with pytest.raises(ValueError, match="slot_pos"):
        da.decode_attention(q, kc, kc, sp[:8], pos)
    with pytest.raises(ValueError, match="multiple of K"):
        da.decode_attention(q[:, :, :3], kc, kc, sp, pos)
    with pytest.raises(TypeError):
        da.decode_attention(q.double(), kc, kc, sp, pos)


@pytest.mark.parametrize("bk,w,expected", [
    (2, 2048, (64, 1)),            # RecurrentGemma-9B: one tile a split
    (4, 8192, (33, 8)),            # ChatGLM3-6B at S = 4,096: a block per SM
    (128, 128, (1, 4)),            # StableLM-1.6B, the CLI default
    (600, 64, (1, 2)),             # the (batch, KV head) pairs fill the card
    (1, 33, (2, 1)),               # a ragged last tile
])
def test_split_rule(bk, w, expected):
    splits, per = da.decode_splits(bk, w)
    assert (splits, per) == expected
    tiles = -(-w // da.TILE)
    assert splits <= tiles and per == -(-tiles // splits)


@settings(max_examples=300, deadline=None)
@given(bk=st.integers(1, 4096), w=st.integers(1, 1 << 17))
def test_every_tile_is_dealt_to_one_split(bk, w):
    """The kernel deals tile t to split t % splits: every tile goes to
    exactly one split, no split gets more than one tile above another, and
    a launch with more than one split has at most a block per SM (it is
    cooperative: all its blocks must be resident at once)."""
    splits, per = da.decode_splits(bk, w)
    tiles = -(-w // da.TILE)
    dealt = [list(range(x, tiles, splits)) for x in range(splits)]
    assert sorted(t for d in dealt for t in d) == list(range(tiles))
    sizes = [len(d) for d in dealt]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert max(sizes) == per <= da.MAX_TILES_PER_SPLIT
    assert splits == 1 or splits * bk <= da.NUM_SMS


@pytest.mark.parametrize("bk,w,g,expected", [
    (16, 8192, 6, (8, 16)),        # InternVL2-26B: a block per SM
    (8, 2048, 1, (16, 2)),         # Qwen1.5-MoE-A2.7B's local decode on 1 x 4
    (2, 2048, 16, (32, 1)),        # RecurrentGemma-9B: one tile a split
    (128, 128, 1, (1, 2)),         # StableLM-1.6B, the CLI default
    (4, 512, 32, (8, 1)),          # 32 query heads a KV head: two blocks
    (1, 65, 6, (2, 1)),            # a ragged last tile
    (1, 1 << 17, 32, (66, 32)),    # one pair over the longest ring tested
])
def test_bf16_split_rule(bk, w, g, expected):
    """``decode_bf16_splits`` deals 64-slot tiles: a block an SM for each
    16 query heads of a pair, never more splits than tiles."""
    splits, per = da.decode_bf16_splits(bk, w, g)
    assert (splits, per) == expected
    tiles = -(-w // da.BF16_TILE)
    assert splits <= tiles and per == -(-tiles // splits)


@settings(max_examples=300, deadline=None)
@given(bk=st.integers(1, 4096), w=st.integers(1, 1 << 17),
       g=st.integers(1, 32))
def test_every_bf16_tile_is_dealt_to_one_split(bk, w, g):
    """The bf16 kernel deals 64-slot tile t to split t % splits: every tile
    to exactly one split, no split more than one tile above another, at
    most ``BF16_MAX_TILES_PER_SPLIT`` (the masks a block keeps), and a
    launch with more than one split at most a block per SM (it is
    cooperative: all its blocks are resident at once)."""
    splits, per = da.decode_bf16_splits(bk, w, g)
    tiles = -(-w // da.BF16_TILE)
    dealt = [list(range(x, tiles, splits)) for x in range(splits)]
    assert sorted(t for d in dealt for t in d) == list(range(tiles))
    sizes = [len(d) for d in dealt]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert max(sizes) == per <= da.BF16_MAX_TILES_PER_SPLIT
    blocks = splits * bk * da.bf16_head_blocks(g)
    assert splits == 1 or blocks <= da.NUM_SMS


@pytest.mark.parametrize("hd,stages", [(4, 8), (64, 8), (100, 4), (128, 4),
                                       (200, 2), (256, 2)])
def test_bf16_stages_keep_128_kb_in_flight(hd, stages):
    """The ring's stages: K and V tiles of 64 slots at the head-dim class
    (64, 128, 256) make ``BF16_IN_FLIGHT`` = 128 KB a block, an even
    number of them (two groups of warps take alternate tiles)."""
    assert da.decode_bf16_stages(hd) == stages
    tile = da.BF16_TILE * da.head_dim_class(hd) * 2
    assert stages * 2 * tile == da.BF16_IN_FLIGHT and stages % 2 == 0


@pytest.mark.parametrize("hd,w,splits,expected", [
    # InternVL2-26B: a 128 KB ring, Q's 16 rows, 16 masks, 4 stages
    (128, 8192, 8, 1024 + 131072 + 4096 + 8 * 16 + 24 * 4 + 1152),
    # hd 100 (rows copied by threads) in the class of 128
    (100, 600, 10, 1024 + 131072 + 4096 + 8 * 1 + 24 * 4 + 1152),
    # RecurrentGemma-9B: two stages of hd 256
    (256, 2048, 32, 1024 + 131072 + 8192 + 8 * 1 + 24 * 2 + 1152),
    # hd 64 over one split of 2,048 tiles: 8 stages, 16 KB of masks
    (64, 64 * 2048, 1, 1024 + 131072 + 2048 + 8 * 2048 + 24 * 8 + 1152),
])
def test_bf16_shared_memory_layout(hd, w, splits, expected):
    """``decode_bf16_smem_bytes`` lays out what the kernel's ``Layout``
    does: alignment slack; the ring (it holds the consumer warps' fp32
    partials after the loop); Q's 16 rows; a 64-bit mask a tile; three
    barriers a stage; the merge's row maxima and sums.
    Every case fits a block's 232,448 bytes."""
    got = da.decode_bf16_smem_bytes(hd, w, splits)
    assert got == expected and got <= 232_448


def test_walks_count_each_dtype_under_its_kernel():
    """On fake tensors of the card's device type (the dry run's), a bf16
    call records its launch's cost under ``decode_attention_bf16`` and an
    fp32 call under ``decode_attention``, the same cost function; nothing
    is launched or counted in ``launch_counts``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.roofline.cost import CostWalk
    before = dict(da.launch_counts)
    with FakeTensorMode():
        for dtype, name in ((torch.bfloat16, "decode_attention_bf16"),
                            (torch.float32, "decode_attention")):
            q = torch.empty(2, 1, 12, 64, dtype=dtype, device="cuda")
            kv = torch.empty(2, 256, 2, 64, dtype=dtype, device="cuda")
            sp = torch.empty(256, dtype=torch.int32, device="cuda")
            pos = torch.empty((), dtype=torch.int32, device="cuda")
            with CostWalk() as walk:
                out = da.decode_attention(q, kv, kv, sp, pos)
            assert out.dtype == dtype and out.shape == q.shape
            kernels = walk.result()["kernels"]
            assert list(kernels) == [name]
            assert kernels[name]["launches"] == 1
            flops, nbytes = da.decode_attention_cost(q, kv, kv, sp, pos)
            assert kernels[name]["flops"] == flops == 4 * 2 * 12 * 64 * 256
            assert kernels[name]["bytes"] == nbytes
    assert da.launch_counts == before


# ---------------------------------------------------------------------------
# decode_self_attention: one layer, carried-over parameters, wrapped ring
# ---------------------------------------------------------------------------

# arch, window: partial RoPE at 0.25 (StableLM) and 0.5 (ChatGLM3), qk-norm
# (Qwen3), RecurrentGemma's local window over MQA
LAYERS = [("stablelm-1.6b", 0), ("chatglm3-6b", 0), ("qwen3-32b", 0),
          ("recurrentgemma-9b", 24)]


def _layer_inputs(arch):
    cfg = j_base.get_config(arch, smoke=True)
    jp = init_tree(jax.random.PRNGKey(2), j_attn.attention_specs(cfg),
                   jnp.float32)
    B, W, pos = 2, 32, 40
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (B, 1, cfg.d_model)).astype(np.float32)
    cache = {"k": rng.normal(0, 1, (B, W, K, hd)).astype(np.float32),
             "v": rng.normal(0, 1, (B, W, K, hd)).astype(np.float32),
             "slot_pos": _slot_pos(W, pos - 1, "ring"),
             "pos": np.asarray(pos, np.int32)}
    return cfg, jp, x, cache


def _torch_cache(cache):
    return {k: torch.from_numpy(np.array(v)) for k, v in cache.items()}


@pytest.mark.parametrize("arch,window", LAYERS, ids=[a for a, _ in LAYERS])
def test_decode_self_attention_matches_reference(arch, window):
    cfg, jp, x, cache = _layer_inputs(arch)
    tcfg = t_base.get_config(arch, smoke=True)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    j_out, j_cache = j_attn.decode_self_attention(
        cfg, jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                  cache.items()}, window=window)
    for impl in ("kernel", "naive"):
        before = _torch_cache(cache)
        out, new = t_attn.decode_self_attention(
            tcfg, tp, torch.from_numpy(x), before, window=window, impl=impl)
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out),
                                   atol=LAYER_TOL, rtol=LAYER_TOL,
                                   err_msg=impl)
        for key in j_cache:
            np.testing.assert_allclose(new[key].numpy(),
                                       np.asarray(j_cache[key]),
                                       atol=LAYER_TOL, rtol=LAYER_TOL,
                                       err_msg=f"{impl}: {key}")
        for key, v in cache.items():       # the old cache is left as it was
            np.testing.assert_array_equal(before[key].numpy(), v)
    assert int(new["pos"]) == 41 and int(new["slot_pos"][40 % 32]) == 40


def test_decode_self_attention_in_place_writes_the_given_cache():
    """``in_place`` (the scanned stack's per-step copy) gives the same
    output and writes the token into the cache it was handed."""
    cfg, jp, x, cache = _layer_inputs("chatglm3-6b")
    tcfg = t_base.get_config("chatglm3-6b", smoke=True)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    copy = _torch_cache(cache)
    out, new = t_attn.decode_self_attention(tcfg, tp, torch.from_numpy(x),
                                            _torch_cache(cache))
    out2, new2 = t_attn.decode_self_attention(tcfg, tp, torch.from_numpy(x),
                                              copy, in_place=True)
    assert torch.equal(out, out2)
    for key in ("k", "v", "slot_pos"):
        assert new2[key] is copy[key]
        assert torch.equal(copy[key], new[key])
    assert int(copy["pos"]) == 40 and int(new2["pos"]) == 41


def test_unknown_decode_impl_raises():
    cfg, jp, x, cache = _layer_inputs("stablelm-1.6b")
    tcfg = t_base.get_config("stablelm-1.6b", smoke=True)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    with pytest.raises(ValueError, match="impl"):
        t_attn.decode_self_attention(tcfg, tp, torch.from_numpy(x),
                                     _torch_cache(cache), impl="pallas")
