"""The port's CUDA kernels (``segment_aggregate``, ``cloud_aggregate``,
``weighted_mean``, ``segment_sum``, ``flash_attention``, ``rglru_scan``,
``decode_attention``) against their plain PyTorch versions, on the card.
Imports only torch and numpy, so it runs on a GPU machine without JAX:
PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels.py
Without a card every case skips: a CUDA kernel has no CPU mode."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels import hier_aggregate as ha  # noqa: E402

# name -> (N, F, M, dtype, edit of the inputs)
CASES = {
    "narrow": (12, 37, 3, torch.float32, None),
    "main_path_shape": (100, 44_426, 5, torch.float32, None),
    "zero_member_edge": (10, 16, 4, torch.float32, "empty_group"),
    "zero_weight_edge": (10, 16, 3, torch.float32, "zero_weight_group"),
    "bf16": (16, 40, 3, torch.bfloat16, None),
    "past_tpu_split_n1000": (1000, 1000, 5, torch.float32, None),
    "many_groups_dynamic_smem": (500, 300, ha.MAX_GROUPS, torch.float32,
                                 None),
    "shard_slab_n60": (60, 44_426, 5, torch.float32, None),
    "odd_row_view_f44426": (100, 44_426, 5, torch.float32, "odd_row"),
    "bf16_odd_row_view_f44426": (100, 44_426, 5, torch.bfloat16, "odd_row"),
    "odd_row_view_f1001": (100, 1001, 5, torch.float32, "odd_row"),
}


def _inputs(cases, name, device):
    """(x, w, g, m) of case ``name``, made from a seed; an ``odd_row`` x is
    a view from row 1 of a buffer one row longer (at F = 44,426 its rows
    are 8-byte aligned in fp32 and 4-byte aligned in bf16, not 16)."""
    n, f, m, dtype, edit = cases[name]
    rng = np.random.default_rng(len(name))
    odd = edit == "odd_row"
    x = torch.from_numpy(rng.normal(0, 1, (n + odd, f)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32))
    g = torch.from_numpy(rng.integers(0, m, n).astype(np.int32))
    if edit == "empty_group":
        g[g == 2] = 0
    if edit == "zero_weight_group":
        w[g == 1] = 0.0
    x = x.to(device, dtype)
    return x[1:] if odd else x, w.to(device), g.to(device), m


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernels_match_plain_versions(cuda, name):
    edit = CASES[name][4]
    x, w, g, m = _inputs(CASES, name, cuda)
    before = dict(ha.launch_counts)
    seg = ha.segment_aggregate(x, w, g, m)
    cloud = ha.cloud_aggregate(x, w)
    again = ha.segment_aggregate(x, w, g, m)
    cloud_again = ha.cloud_aggregate(x, w)
    torch.cuda.synchronize()
    assert ha.launch_counts["segment_aggregate"] == \
        before["segment_aggregate"] + 2
    assert torch.equal(seg, again)          # no atomics: run to run equal
    assert ha.launch_counts["cloud_aggregate"] == \
        before["cloud_aggregate"] + 2
    assert torch.equal(cloud, cloud_again)
    for out, ref in ((seg, ha.segment_aggregate_plain(x, w, g, m)),
                     (cloud, ha.cloud_aggregate_plain(x, w))):
        assert out.dtype == torch.float32 and out.shape == x.shape
        assert torch.isfinite(out).all()
        assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    if edit == "zero_weight_group":
        assert (seg[g == 1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [40, 600])
def test_cuda_cloud_aggregate_all_zero_weights_give_nan(cuda, n):
    """No guard, at every N: NaN like the plain version (the TPU kernel's
    fall-through to the guarded segment kernel for N > 512 is not
    followed)."""
    x = torch.from_numpy(np.random.default_rng(n).normal(
        0, 1, (n, 1001)).astype(np.float32)).to(cuda)
    w = torch.zeros(n, device=cuda)
    out = ha.cloud_aggregate(x, w)
    assert ha.cloud_aggregate_plain(x, w).isnan().all()
    assert out.shape == x.shape and out.isnan().all()


def _device_kernels(fn):
    """name -> count of the device kernels one run of ``fn`` launches
    (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["cloud_aggregate", "weighted_mean"])
def test_cuda_cloud_and_mean_launch_one_kernel_a_call(cuda, kernel):
    """Every case's shape (the multi-slice ones of ``weighted_mean``
    included) is one launch of the kernel and nothing else (at most one:
    the profiler may drop a record)."""
    if kernel == "cloud_aggregate":
        inputs = [_inputs(CASES, name, cuda)[:2] for name in sorted(CASES)]
    else:
        inputs = [_mean_inputs(name, cuda) for name in sorted(MEAN_CASES)]
    launched = _device_kernels(
        lambda: [getattr(ha, kernel)(x, w) for x, w in inputs])
    assert launched and all(f"{kernel}_kernel" in k for k in launched)
    assert sum(launched.values()) <= len(inputs)


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back(cuda):
    x = torch.zeros(4, 8, device=cuda)
    with pytest.raises(ValueError):
        ha.segment_aggregate(x, torch.ones(4), torch.zeros(4, dtype=torch.int32,
                                                          device=cuda), 2)


# name -> (N, F, M, dtype, edit of the inputs)
SUM_CASES = {
    "streaming_chunk": (8192, 1024, 16, torch.float32, None),
    "lenet_cohort": (100, 44_426, 5, torch.float32, None),
    "chunk_of_1": (1, 1024, 16, torch.float32, None),
    "chunk_of_7": (7, 1024, 16, torch.float32, None),
    "ragged_f1001": (8192, 1001, 16, torch.float32, None),
    "bf16": (4096, 1024, 16, torch.bfloat16, None),
    "memberless_group": (1000, 300, 6, torch.float32, "empty_group"),
    "zero_weight_group": (1000, 300, 5, torch.float32, "zero_weight_group"),
    "max_groups": (2000, 300, ha.MAX_GROUPS, torch.float32, None),
    "odd_row_view_f44426": (100, 44_426, 5, torch.float32, "odd_row"),
    "bf16_odd_row_view_f44426": (100, 44_426, 5, torch.bfloat16, "odd_row"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SUM_CASES))
def test_cuda_segment_sum_matches_plain_version(cuda, name):
    f, edit = SUM_CASES[name][1], SUM_CASES[name][4]
    x, w, g, m = _inputs(SUM_CASES, name, cuda)
    before = ha.launch_counts["segment_sum"]
    out = ha.segment_sum(x, w, g, m)
    again = ha.segment_sum(x, w, g, m)
    acc = torch.full((m, f), 0.5, device=cuda)
    ha.segment_sum(x, w, g, m, out=acc)
    torch.cuda.synchronize()
    assert ha.launch_counts["segment_sum"] == before + 3
    ref = ha.segment_sum_plain(x, w, g, m)
    assert out.dtype == torch.float32 and tuple(out.shape) == (m, f)
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    assert torch.equal(out, again)          # no atomics: run to run equal
    assert torch.equal(acc, 0.5 + out)      # chunk sum first, then added
    if edit == "empty_group":
        assert (out[2] == 0).all()
    if edit == "zero_weight_group":
        assert (out[1] == 0).all()


# name -> (N, F, dtype, edit of the weights)
MEAN_CASES = {
    "one_row": (1, 1001, torch.float32, None),
    "n513_past_tpu_split": (513, 1001, torch.float32, None),
    "ragged_f37": (600, 37, torch.float32, None),
    "n1030_ragged": (1030, 64, torch.float32, None),
    "one_nonzero_weight": (300, 1001, torch.float32, "one_nonzero"),
    "all_zero_weights": (40, 300, torch.float32, "all_zero"),
    "bf16": (513, 1001, torch.bfloat16, None),
    "path_slab": (60, 44_426, torch.float32, None),
    "many_rows_few_cols": (16_384, 1024, torch.float32, None),
    "multi_slice_f44426": (4096, 44_426, torch.float32, None),
    # row views from an odd row: 8-byte (fp32) and 4-byte (bf16) loads at
    # F = 44,426, 4-byte loads at F = 1,001
    "odd_row_view_f44426": (100, 44_426, torch.float32, "odd_row"),
    "bf16_odd_row_view_f44426": (100, 44_426, torch.bfloat16, "odd_row"),
    "odd_row_view_f1001": (513, 1001, torch.float32, "odd_row"),
}


def _mean_inputs(name, device):
    """(x, w) of ``MEAN_CASES[name]``, made from a seed; an ``odd_row`` x
    is a view from row 1 of a buffer one row longer."""
    n, f, dtype, edit = MEAN_CASES[name]
    rng = np.random.default_rng(len(name))
    odd = edit == "odd_row"
    x = torch.from_numpy(rng.normal(0, 1, (n + odd, f)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32))
    if edit == "one_nonzero":
        w[:] = 0.0
        w[n // 2] = 3.0
    if edit == "all_zero":
        w[:] = 0.0
    x = x.to(device, dtype)
    return x[1:] if odd else x, w.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MEAN_CASES))
def test_cuda_weighted_mean_matches_plain_version(cuda, name):
    n, f, dtype, edit = MEAN_CASES[name]
    x, w = _mean_inputs(name, cuda)
    before = ha.launch_counts["weighted_mean"]
    out = ha.weighted_mean(x, w)
    again = ha.weighted_mean(x, w)
    torch.cuda.synchronize()
    assert ha.launch_counts["weighted_mean"] == before + 2
    ref = ha.weighted_mean_plain(x, w)
    assert out.dtype == torch.float32 and tuple(out.shape) == (f,)
    assert torch.equal(out.isnan(), ref.isnan())
    if edit == "all_zero":                  # 0/0, as in the reference
        assert out.isnan().all()
        return
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    assert torch.equal(out, again)          # no atomics: run to run equal
    if edit == "one_nonzero":
        assert (out - x[n // 2].float()).abs().max() <= 1e-6 * ref.abs().max()


@pytest.mark.cuda
def test_cuda_weighted_mean_workspace_grows_and_counters_return_to_0(
        cuda, monkeypatch):
    """Multi-slice shapes in a row, a ``segment_sum`` between them: the
    shared workspace grows for the larger one (never a smaller one reused),
    the tile counters are 0 after every call, and the first shape's result
    is the same bits after the others."""
    monkeypatch.setattr(ha, "_scratch", {})
    small, large = (_mean_inputs(name, cuda) for name in
                    ("many_rows_few_cols", "multi_slice_f44426"))
    for x, _ in (small, large):
        assert ha.weighted_mean_plan(*x.shape)[0] > 1
    first = ha.weighted_mean(*small)
    torch.cuda.synchronize()
    (counters, ws), = ha._scratch.values()
    assert int(counters.count_nonzero()) == 0
    x, w = large
    slices = ha.weighted_mean_plan(*x.shape)[0]
    tiles = -(-x.shape[1] // ha.TILE)
    assert ws.numel() < tiles * slices * (ha.TILE + 4)
    out = ha.weighted_mean(x, w)
    torch.cuda.synchronize()
    (counters, grown), = ha._scratch.values()
    assert grown.numel() >= tiles * slices * (ha.TILE + 4)
    assert int(counters.count_nonzero()) == 0
    assert (out - ha.weighted_mean_plain(x, w)).abs().max() <= \
        1e-5 * ha.weighted_mean_plain(x, w).abs().max()
    sx, sw, sg, m = _inputs(SUM_CASES, "streaming_chunk", cuda)
    ha.segment_sum(sx, sw, sg, m)
    again = ha.weighted_mean(*small)
    torch.cuda.synchronize()
    (counters, _), = ha._scratch.values()
    assert int(counters.count_nonzero()) == 0
    assert torch.equal(first, again)


# B, Sq, Sk, H, K, hd, causal, window, dtype, layout
ATTN_CASES = {
    # tests/test_kernels.py's ATTN_CASES
    "gqa": (2, 128, 128, 8, 4, 64, True, 0, torch.float32, None),
    "window_64": (1, 256, 256, 4, 4, 32, True, 64, torch.float32, None),
    "ragged_100": (2, 100, 100, 8, 2, 64, True, 0, torch.float32, None),
    "decode_1_of_384": (1, 1, 384, 8, 8, 64, True, 0, torch.float32, None),
    "decode_ragged_250": (1, 1, 250, 4, 2, 32, True, 0, torch.float32, None),
    "decode_window": (1, 1, 512, 4, 4, 64, True, 128, torch.float32, None),
    "mqa_128": (2, 64, 64, 8, 1, 128, True, 0, torch.float32, None),
    "swa_48": (1, 192, 192, 6, 3, 32, True, 48, torch.float32, None),
    # RecurrentGemma's MQA at head_dim 256 under a window
    "mqa_256_window": (1, 300, 300, 16, 1, 256, True, 128, torch.float32,
                       None),
    # ragged Sq and Sk, Sq < Sk
    "ragged_sq_sk": (2, 77, 333, 4, 2, 32, True, 0, torch.float32, None),
    # query tile 1 (rows 64..127, window 40): its first key tile (keys
    # 0..31) is live for rows 64..71 and fully masked for rows 72..127
    "masked_leading_tile": (1, 256, 256, 4, 1, 64, True, 40, torch.float32,
                            None),
    "non_causal": (2, 200, 200, 8, 2, 64, False, 0, torch.float32, None),
    "non_causal_sq_lt_sk": (1, 70, 300, 4, 1, 100, False, 0, torch.float32,
                            None),
    "non_causal_window": (1, 130, 130, 4, 2, 32, False, 24, torch.float32,
                          None),
    "bf16": (2, 128, 128, 8, 4, 64, True, 0, torch.bfloat16, None),
    # q, k, v as views into one fused (B, S, H + 2K, hd) projection
    "strided_views": (2, 96, 96, 8, 2, 64, True, 32, torch.float32, "fused"),
    # the serving shape of full-width RecurrentGemma-9B
    "serving": (2, 4096, 4096, 16, 1, 256, True, 2048, torch.float32, None),
    # ChatGLM3-6B's serving prefill and StableLM-1.6B's CLI prefill (MHA)
    "chatglm3": (2, 4096, 4096, 32, 2, 128, True, 0, torch.float32, None),
    "stablelm_cli": (4, 64, 64, 32, 32, 64, True, 0, torch.float32, None),
    # g = 6 divides no block's row count (a power of 2, 8 to 128)
    "group_6_hd128": (2, 100, 100, 12, 2, 128, True, 0, torch.float32,
                      None),
    "group_6_hd64": (1, 90, 90, 12, 2, 64, True, 20, torch.float32, None),
    # g = 16 with ragged Sq < Sk; one query row at g = 16
    "g16_ragged_sq_lt_sk": (1, 50, 300, 16, 1, 128, True, 0, torch.float32,
                            None),
    "g16_sq_1": (2, 1, 200, 16, 1, 256, True, 64, torch.float32, None),
    "hd_4": (1, 40, 40, 4, 2, 4, True, 0, torch.float32, None),
    # a window of 7 keys, under one key tile
    "window_7": (1, 200, 200, 8, 2, 64, True, 7, torch.float32, None),
    "bf16_hd256": (1, 300, 300, 16, 1, 256, True, 128, torch.bfloat16,
                   None),
}


def _attn_inputs(case, cuda):
    B, Sq, Sk, H, K, hd, _, _, dtype, layout = case
    rng = np.random.default_rng(Sq * 7 + Sk)
    if layout == "fused":
        fused = torch.from_numpy(rng.normal(
            0, 1, (B, Sq, H + 2 * K, hd)).astype(np.float32)).to(cuda, dtype)
        return fused[:, :, :H], fused[:, :, H:H + K], fused[:, :, H + K:]
    return tuple(torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
                 .to(cuda, dtype)
                 for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_cuda_flash_attention_matches_plain_version(cuda, name):
    """fp32 within 2e-5 (tests/test_kernels.py's tolerance); bf16 output
    within 2 bf16 ulps of the largest value.  Two launches agree bit for
    bit."""
    from repro_torch.kernels import flash_attention as fa
    case = ATTN_CASES[name]
    causal, window, dtype = case[6], case[7], case[8]
    q, k, v = _attn_inputs(case, cuda)
    before = fa.launch_counts["flash_attention"]
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    again = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launch_counts["flash_attention"] == before + 2
    ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert out.dtype == dtype and out.shape == q.shape
    assert torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs().max()
    tol = 2e-5 if dtype == torch.float32 else 2 * 2 ** -8 * ref.abs().max()
    assert err <= tol
    assert torch.equal(out, again)


SMEM_PER_BLOCK = 232_448     # shared memory a block can take on an H100


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_flash_attention_tile_rule_fits_every_config(arch):
    """For each config's head dim and group: a block at the most warps
    fits the card's shared memory, and the rule's warps at a prompt of
    4,096 at B = 2 give the card a block per SM."""
    from repro_torch.kernels import flash_attention as fa
    cfg = get_config(arch)
    hd = cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    assert fa.attention_smem_bytes(hd, fa.MAX_WARPS) <= SMEM_PER_BLOCK
    w = fa.attention_warps(2, 4096, h, kv, hd)
    assert w in (1, 2, 4, 8)
    assert fa.attention_blocks(2, 4096, h, kv, hd, w) >= fa.NUM_SMS


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_decode_attention_layout_fits_every_config(arch):
    """For each config's head dim and group, and at the most query heads a
    KV head, one block of the decode kernel at B = 2 over an 8,192-slot
    cache fits the card's shared memory, fp32 and bf16."""
    from repro_torch.kernels import decode_attention as da
    cfg = get_config(arch)
    hd = cfg.resolved_head_dim
    g = cfg.num_heads // cfg.num_kv_heads
    splits, _ = da.decode_splits(2 * cfg.num_kv_heads, 8192)
    for group in (g, da.MAX_GROUP):
        for bf16 in (False, True):
            assert da.decode_smem_bytes(hd, group, 8192, splits,
                                        bf16) <= SMEM_PER_BLOCK


# B, W, K: the decode shapes of RecurrentGemma-9B (a full 2,048-slot ring),
# ChatGLM3-6B (8,192 slots at S = 4,096) and StableLM-1.6B in the CLI.
SERVING_DECODES = {"recurrentgemma": (2, 2048, 1), "chatglm3": (2, 8192, 2),
                   "stablelm_cli": (4, 128, 32)}


@pytest.mark.parametrize("name", sorted(SERVING_DECODES))
def test_decode_split_rule_fills_the_card(name):
    """The serving decode shapes give every SM a block, but for fewer than
    one per (batch, KV head) pair or where the tiles run out, and no SM
    two."""
    from repro_torch.kernels import decode_attention as da
    B, W, K = SERVING_DECODES[name]
    splits, per = da.decode_splits(B * K, W)
    blocks = splits * B * K
    assert blocks > da.NUM_SMS - B * K or per == 1
    assert blocks <= da.NUM_SMS


# B, Sq, H, K, hd: the prefill shapes of RecurrentGemma-9B and ChatGLM3-6B
# in serving, and of StableLM-1.6B in the serving CLI's default run.
SERVING_PREFILLS = {"recurrentgemma": (2, 4096, 16, 1, 256),
                    "chatglm3": (2, 4096, 32, 2, 128),
                    "stablelm_cli": (4, 64, 32, 32, 64)}


@pytest.mark.parametrize("name", sorted(SERVING_PREFILLS))
def test_flash_attention_tile_rule_fills_the_card(name):
    from repro_torch.kernels import flash_attention as fa
    B, Sq, H, K, hd = SERVING_PREFILLS[name]
    w = fa.attention_warps(B, Sq, H, K, hd)
    assert fa.attention_blocks(B, Sq, H, K, hd, w) >= fa.NUM_SMS
    assert fa.attention_smem_bytes(hd, w) <= SMEM_PER_BLOCK
    if name != "stablelm_cli":          # the full prompts take full blocks
        assert w == fa.MAX_WARPS
        assert fa.attention_blocks(B, Sq, H, K, hd, w) >= 1024


# B, S, D, dtype, chunks (None: the wrapper's rule)
SCAN_CASES = {
    "b2_s64_d128": (2, 64, 128, torch.float32, None),
    "ragged_s300_d96": (1, 300, 96, torch.float32, None),
    "tiny_s17_d8": (3, 17, 8, torch.float32, None),
    "s512_d256": (1, 512, 256, torch.float32, None),
    "one_chunk": (1, 512, 256, torch.float32, 1),
    "three_chunks_ragged": (2, 301, 200, torch.float32, 3),
    "chunk_per_step": (1, 50, 130, torch.float32, 50),
    "bf16": (2, 256, 128, torch.bfloat16, None),
    "serving": (2, 4096, 4096, torch.float32, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCAN_CASES))
def test_cuda_rglru_scan_matches_plain_version(cuda, name, monkeypatch):
    """Within 1e-5 of the largest |h|: the kernel runs each chunk
    sequentially, the plain version is a log-depth scan."""
    from repro_torch.kernels import rglru_scan as rs
    B, S, D, dtype, chunks = SCAN_CASES[name]
    if chunks is not None:
        monkeypatch.setattr(rs, "scan_chunks", lambda *_: chunks)
    rng = np.random.default_rng(S + D)
    a = torch.from_numpy(rng.uniform(0.7, 0.999, (B, S, D)).astype(
        np.float32)).to(cuda, dtype)
    b = torch.from_numpy(rng.normal(0, 1, (B, S, D)).astype(np.float32)).to(
        cuda, dtype)
    before = rs.launch_counts["rglru_scan"]
    out = rs.rglru_scan(a, b)
    again = rs.rglru_scan(a, b)
    torch.cuda.synchronize()
    assert rs.launch_counts["rglru_scan"] == before + 2
    ref = rs.rglru_scan_plain(a, b)
    assert out.dtype == torch.float32 and out.shape == a.shape
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    assert torch.equal(out, again)


# B, W, H, K, hd, pos, window, slot layout: tests/test_kernels.py's
# DECODE_CASES, its ring-wrapped case, an empty cache, a view [l] of a
# stacked (L, B, W, 2, K, hd) cache, the decode shapes of full-width
# RecurrentGemma-9B (ring full), ChatGLM3-6B and StableLM-1.6B, then the
# edges of the kernel's design: 32 query heads a KV head (two m-tiles, the
# most), head dims 4 and 100 (padded k-steps; bf16 rows copied 8 bytes at
# a time), a wrapped ring under a window shorter than a tile, a ragged W
# whose last tile alone counts, more (batch, KV head) pairs than SMs, and
# an odd count of split partials a row (one query head, three splits).
DECODE_CASES = {
    "gqa_2-256-8-4-64": (2, 256, 8, 4, 64, 100, 0, "prefix"),
    "ragged_1-300-4-2-32": (1, 300, 4, 2, 32, 299, 0, "prefix"),
    "window_2-512-8-8-128": (2, 512, 8, 8, 128, 400, 128, "prefix"),
    "mqa_1-64-4-1-64": (1, 64, 4, 1, 64, 10, 0, "prefix"),
    "ring_wrapped": (2, 32, 4, 2, 16, 40, 0, "ring"),
    "all_empty": (2, 64, 8, 2, 32, 0, 0, "empty"),
    "stacked_view": (2, 96, 8, 2, 32, 71, 64, "stacked"),
    "recurrentgemma": (2, 2048, 16, 1, 256, 4096, 2048, "ring"),
    "chatglm3": (2, 8192, 32, 2, 128, 4096, 0, "prefix"),
    "stablelm": (4, 128, 32, 32, 64, 64, 0, "prefix"),
    "group_32_hd128": (2, 512, 64, 2, 128, 300, 0, "prefix"),
    "group_32_hd256": (1, 1024, 32, 1, 256, 2000, 512, "ring"),
    "head_dim_4": (2, 96, 8, 2, 4, 70, 0, "prefix"),
    "head_dim_100": (2, 200, 12, 3, 100, 150, 0, "prefix"),
    "ring_window_under_a_tile": (2, 96, 8, 2, 32, 300, 20, "ring"),
    "ragged_last_tile_only": (2, 100, 8, 2, 64, 500, 0, "tail"),
    "pairs_600": (300, 64, 4, 2, 32, 40, 0, "prefix"),
    "mha_three_splits": (1, 96, 2, 2, 32, 90, 0, "prefix"),
}


def _decode_inputs(case, cuda, dtype):
    """q, k_cache, v_cache, slot_pos, pos on the card."""
    B, W, H, K, hd, pos, window, layout = case
    rng = np.random.default_rng(W + H + hd)
    if layout == "prefix":
        sp = np.full(W, -10**9, np.int32)
        sp[:min(pos + 1, W)] = np.arange(min(pos + 1, W))
    elif layout == "empty":
        sp = np.full(W, -10**9, np.int32)
    elif layout == "tail":                 # only the slots past the last
        sp = np.full(W, -10**9, np.int32)  # whole tile were written
        tail = np.arange(W // 32 * 32, W)
        sp[tail] = pos - (W - 1 - tail)
    else:
        sp = np.asarray([pos - ((pos - w) % W) for w in range(W)])
        sp = np.where(sp >= 0, sp, -10**9).astype(np.int32)
    q = torch.from_numpy(rng.normal(0, 1, (B, 1, H, hd)).astype(np.float32))
    if layout == "stacked":
        kv = torch.from_numpy(rng.normal(0, 1, (3, B, W, 2, K, hd)).astype(
            np.float32)).to(cuda, dtype)
        sps = torch.from_numpy(np.stack([sp - 1, sp, sp + 1])).to(cuda)
        poss = torch.tensor([pos - 1, pos, pos + 1], dtype=torch.int32,
                            device=cuda)
        return (q.to(cuda, dtype), kv[1, :, :, 0], kv[1, :, :, 1], sps[1],
                poss[1])
    k, v = (torch.from_numpy(rng.normal(0, 1, (B, W, K, hd)).astype(
        np.float32)).to(cuda, dtype) for _ in range(2))
    return (q.to(cuda, dtype), k, v, torch.from_numpy(sp).to(cuda),
            torch.tensor(pos, dtype=torch.int32, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_cuda_decode_attention_matches_plain_version(cuda, name, dtype):
    """fp32 within 1e-5 of the output's scale; bf16 output within 2 bf16
    ulps of the largest value.  Two launches agree bit for bit (the
    partials are merged in a fixed order, whichever block comes last)."""
    from repro_torch.kernels import decode_attention as da
    case = DECODE_CASES[name]
    window = case[6]
    q, k, v, sp, pos = _decode_inputs(case, cuda, dtype)
    before = da.launch_counts["decode_attention"]
    out = da.decode_attention(q, k, v, sp, pos, window=window)
    again = da.decode_attention(q, k, v, sp, pos, window=window)
    torch.cuda.synchronize()
    assert da.launch_counts["decode_attention"] == before + 2
    ref = da.decode_attention_plain(q, k, v, sp, pos, window=window)
    assert out.dtype == dtype and out.shape == q.shape
    assert torch.isfinite(out).all()
    scale = ref.float().abs().max()
    err = (out.float() - ref.float()).abs().max()
    assert err <= (1e-5 if dtype == torch.float32 else 2 * 2 ** -8) * scale
    assert torch.equal(out, again)


@pytest.mark.cuda
def test_cuda_decode_attention_counters_reset_between_shapes(cuda):
    """Two shapes whose (batch, KV head) pairs each merge several clusters'
    partials through the wrapper's counters, and one that merges none,
    called back to back, then in reverse order: each call gives what its
    first call gave, so every launch left its counters at 0."""
    from repro_torch.kernels import decode_attention as da
    names = ("recurrentgemma", "chatglm3", "stablelm")
    inputs = {n: _decode_inputs(DECODE_CASES[n], cuda, torch.float32)
              for n in names}
    first = {n: da.decode_attention(*inputs[n], window=DECODE_CASES[n][6])
             for n in names}
    for n in names[::-1] + names:
        out = da.decode_attention(*inputs[n], window=DECODE_CASES[n][6])
        torch.cuda.synchronize()
        assert torch.equal(out, first[n]), n
    for n in names:
        ref = da.decode_attention_plain(*inputs[n], window=DECODE_CASES[n][6])
        assert (first[n] - ref).abs().max() <= 1e-5 * ref.abs().max(), n


@pytest.mark.cuda
def test_cuda_attention_and_scan_raise_instead_of_falling_back(cuda):
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rs
    q = torch.zeros(1, 8, 2, 6, device=cuda)         # head_dim not /4
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 10, device=cuda)[..., :8]  # stride 10 not /4
    kv = torch.zeros(1, 8, 2, 8, device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention(q, kv, kv)
    a = torch.zeros(1, 8, 4, device=cuda)
    with pytest.raises(ValueError):
        rs.rglru_scan(a.transpose(1, 2), a.transpose(1, 2))
    # decode_attention: a bad stride, dtype or device raises; nothing runs
    before = da.launch_counts["decode_attention"]
    q = torch.zeros(1, 1, 4, 8, device=cuda)
    kv = torch.zeros(1, 16, 2, 8, device=cuda)
    sp = torch.zeros(16, dtype=torch.int32, device=cuda)
    pos = torch.tensor(3, dtype=torch.int32, device=cuda)
    narrow = torch.zeros(1, 16, 2, 10, device=cuda)[..., :8]
    with pytest.raises(ValueError):                   # stride 10 not /4
        da.decode_attention(q, narrow, kv, sp, pos)
    with pytest.raises(TypeError):
        da.decode_attention(q, kv.bfloat16(), kv, sp, pos)
    with pytest.raises(ValueError):
        da.decode_attention(q, kv.cpu(), kv, sp, pos)
    with pytest.raises(ValueError):
        da.decode_attention(q, kv, kv, sp, pos.cpu())
    assert da.launch_counts["decode_attention"] == before
