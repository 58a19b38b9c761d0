"""The port's CUDA aggregation kernels (``segment_aggregate``,
``cloud_aggregate``, ``segment_sum``) against their plain PyTorch versions,
on the card.  Imports only torch and numpy, so it runs on a GPU machine
without JAX:  PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels.py
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
