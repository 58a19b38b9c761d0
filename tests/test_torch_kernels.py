"""The port's CUDA kernels (``segment_aggregate``, ``cloud_aggregate``,
``weighted_mean``, ``segment_sum``, ``flash_attention``, ``rglru_scan``,
``decode_attention``) against their plain PyTorch versions, on the card.
Imports only torch and numpy, so it runs on a GPU machine without JAX:
PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels.py
Without a card every case skips: a CUDA kernel has no CPU mode."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernels_match_plain_versions(cuda, name):
    n, f, m, dtype, edit = CASES[name]
    rng = np.random.default_rng(len(name))
    x = torch.from_numpy(rng.normal(0, 1, (n, f)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32))
    g = torch.from_numpy(rng.integers(0, m, n).astype(np.int32))
    if edit == "empty_group":
        g[g == 2] = 0
    if edit == "zero_weight_group":
        w[g == 1] = 0.0
    x, w, g = x.to(cuda, dtype), w.to(cuda), g.to(cuda)
    before = dict(ha.launch_counts)
    seg = ha.segment_aggregate(x, w, g, m)
    cloud = ha.cloud_aggregate(x, w)
    torch.cuda.synchronize()
    assert ha.launch_counts["segment_aggregate"] == \
        before["segment_aggregate"] + 1
    assert ha.launch_counts["cloud_aggregate"] == \
        before["cloud_aggregate"] + 1
    for out, ref in ((seg, ha.segment_aggregate_plain(x, w, g, m)),
                     (cloud, ha.cloud_aggregate_plain(x, w))):
        assert out.dtype == torch.float32 and out.shape == x.shape
        assert torch.isfinite(out).all()
        assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    if edit == "zero_weight_group":
        assert (seg[g == 1] == 0).all()


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
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SUM_CASES))
def test_cuda_segment_sum_matches_plain_version(cuda, name):
    n, f, m, dtype, edit = SUM_CASES[name]
    rng = np.random.default_rng(len(name))
    x = torch.from_numpy(rng.normal(0, 1, (n, f)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32))
    g = torch.from_numpy(rng.integers(0, m, n).astype(np.int32))
    if edit == "empty_group":
        g[g == 2] = 0
    if edit == "zero_weight_group":
        w[g == 1] = 0.0
    x, w, g = x.to(cuda, dtype), w.to(cuda), g.to(cuda)
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
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MEAN_CASES))
def test_cuda_weighted_mean_matches_plain_version(cuda, name):
    n, f, dtype, edit = MEAN_CASES[name]
    rng = np.random.default_rng(len(name))
    x = torch.from_numpy(rng.normal(0, 1, (n, f)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32))
    if edit == "one_nonzero":
        w[:] = 0.0
        w[n // 2] = 3.0
    if edit == "all_zero":
        w[:] = 0.0
    x, w = x.to(cuda, dtype), w.to(cuda)
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
# stacked (L, B, W, 2, K, hd) cache, and the decode shapes of full-width
# RecurrentGemma-9B (ring full), ChatGLM3-6B and StableLM-1.6B.
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
    partials are combined in split order, no atomics)."""
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
