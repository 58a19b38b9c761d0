"""The plain versions of the port's K5 (``flash_attention``) and K6
(``rglru_scan``) kernels against the JAX package's Pallas kernels (in
interpret mode, as ``tests/test_kernels.py`` runs them on the CPU) and its
``ref.py`` oracles, on the same numpy inputs, at the JAX tests' own
tolerances: 2e-5 for attention; 1e-4 for the scan (a log-depth scan
against the reference's sequential kernel and associative oracle)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops, ref  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rglru_scan as rs  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402

# B, Sq, Sk, H, K, hd, causal, window: tests/test_kernels.py's ATTN_CASES,
# then MQA at RecurrentGemma's head_dim 256 under a window, and two
# non-causal cases (Sq == Sk and Sq < Sk).
ATTN_CASES = [
    (2, 128, 128, 8, 4, 64, True, 0),
    (1, 256, 256, 4, 4, 32, True, 64),
    (2, 100, 100, 8, 2, 64, True, 0),
    (1, 1, 384, 8, 8, 64, True, 0),
    (1, 1, 250, 4, 2, 32, True, 0),
    (1, 1, 512, 4, 4, 64, True, 128),
    (2, 64, 64, 8, 1, 128, True, 0),
    (1, 192, 192, 6, 3, 32, True, 48),
    (1, 300, 300, 16, 1, 256, True, 128),
    (2, 128, 128, 4, 2, 64, False, 0),
    (1, 64, 256, 4, 1, 32, False, 0),
]
RGLRU_CASES = [(2, 64, 128), (1, 300, 96), (3, 17, 8), (1, 512, 256)]
ATTN_TOL = 2e-5
SCAN_TOL = 1e-4


def _qkv(case, seed=0):
    B, Sq, Sk, H, K, hd, _, _ = case
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, Sq, H, hd)).astype(np.float32),
            rng.normal(0, 1, (B, Sk, K, hd)).astype(np.float32),
            rng.normal(0, 1, (B, Sk, K, hd)).astype(np.float32))


@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_plain_matches_pallas_and_oracle(case):
    causal, window = case[6], case[7]
    q, k, v = _qkv(case)
    out = fa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                             causal=causal, window=window).numpy()
    plain = fa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                     causal=causal, window=window).numpy()
    np.testing.assert_array_equal(out, plain)     # the CPU takes the plain one
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for other in (ops.flash_attention(jq, jk, jv, causal=causal,
                                      window=window),
                  ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                          window=window)):
        np.testing.assert_allclose(out, np.asarray(other), rtol=ATTN_TOL,
                                   atol=ATTN_TOL)


def test_flash_attention_plain_bf16():
    case = (2, 128, 128, 8, 4, 64, True, 0)
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16) for t in _qkv(case))
    out = fa.flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (q, k, v))
    r = ref.flash_attention_ref(jq, jk, jv)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(r, np.float32), atol=3e-2)


@pytest.mark.parametrize("case", [(1, 160, 160, 4, 1, 64, True, 64),
                                  (2, 96, 96, 8, 2, 32, True, 0),
                                  (1, 64, 64, 4, 4, 32, False, 16)],
                         ids=lambda c: "-".join(map(str, c)))
def test_naive_attention_matches_reference(case):
    causal, window = case[6], case[7]
    q, k, v = _qkv(case, seed=1)
    pos = np.arange(case[1], dtype=np.int32)
    out = t_attn.naive_attention(*map(torch.from_numpy, (q, k, v, pos, pos)),
                                 causal, window).numpy()
    r = j_attn.naive_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                               causal, window)
    np.testing.assert_allclose(out, np.asarray(r), rtol=ATTN_TOL,
                               atol=ATTN_TOL)
    kernel = fa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                causal=causal, window=window).numpy()
    np.testing.assert_allclose(kernel, out, rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("bad", ["h_not_multiple_of_k", "dtype_mismatch",
                                 "causal_sq_past_sk", "rank"])
def test_flash_attention_rejects_bad_inputs(bad):
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    v = torch.zeros(1, 8, 2, 16)
    if bad == "h_not_multiple_of_k":
        k = v = torch.zeros(1, 8, 3, 16)
    elif bad == "dtype_mismatch":
        k = k.to(torch.bfloat16)
    elif bad == "causal_sq_past_sk":
        q = torch.zeros(1, 9, 4, 16)
    else:
        q = q[0]
    with pytest.raises((ValueError, TypeError)):
        fa.flash_attention(q, k, v)


def _scan_inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    B, S, D = case
    return (rng.uniform(0.7, 0.999, (B, S, D)).astype(np.float32),
            rng.normal(0, 1, (B, S, D)).astype(np.float32))


@pytest.mark.parametrize("case", RGLRU_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_rglru_scan_plain_matches_pallas_and_oracle(case):
    a, b = _scan_inputs(case)
    h = rs.rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert h.dtype == torch.float32
    np.testing.assert_array_equal(
        h.numpy(), rs.rglru_scan_plain(torch.from_numpy(a),
                                       torch.from_numpy(b)).numpy())
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for other in (ops.rglru_scan(ja, jb), ref.rglru_scan_ref(ja, jb)):
        np.testing.assert_allclose(h.numpy(), np.asarray(other),
                                   rtol=SCAN_TOL, atol=SCAN_TOL)


@pytest.mark.parametrize("case", RGLRU_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_rglru_scan_plain_matches_float64_recurrence(case):
    """Against the recurrence itself, run step by step in float64."""
    a, b = _scan_inputs(case, seed=1)
    h = rs.rglru_scan_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    exact = np.zeros(b.shape, np.float64)
    state = np.zeros((b.shape[0], b.shape[2]), np.float64)
    for t in range(b.shape[1]):
        state = a[:, t].astype(np.float64) * state + b[:, t]
        exact[:, t] = state
    scale = np.abs(exact).max()
    assert np.abs(h - exact).max() <= 1e-5 * scale


def test_scan_chunks_rule():
    # serving shape: 2 x 4096 chains -> 33 chunks of 125 steps
    assert rs.scan_chunks(2, 4096, 4096) == 33
    # chains that fill the card alone, or too short a sequence: one chunk
    assert rs.scan_chunks(128, 4096, 4096) == 1
    assert rs.scan_chunks(1, 100, 8) == 1
    assert rs.scan_chunks(1, 640, 8) == 10


@pytest.mark.parametrize("bad", ["shape", "dtype", "rank"])
def test_rglru_scan_rejects_bad_inputs(bad):
    a = torch.zeros(1, 8, 4)
    b = torch.zeros(1, 8, 4)
    if bad == "shape":
        b = torch.zeros(1, 8, 5)
    elif bad == "dtype":
        b = b.double()
    else:
        a, b = a[0], b[0]
    with pytest.raises((ValueError, TypeError)):
        rs.rglru_scan(a, b)
