"""The bf16 path of the port's K5 (``csrc/flash_attention_bf16.cu``) on the
CPU, where the kernel cannot run:

(a) a plain emulation of the kernel's arithmetic (written here: 64-key
    tiles over blocks of 64 flattened (position, head) rows, bf16 x bf16
    products summed in fp32, an fp32 online softmax, P split into bf16
    ``hi + lo`` for the P V products, a bf16 store) held to the JAX
    package's dense oracle (``ref.flash_attention_ref``) and its Pallas
    kernel (``ops.flash_attention``, interpret mode, as its own tests run
    it), on the same numpy-seeded bf16 inputs, within 1 bf16 ulp of each
    output's scale (the card's check allows 2).  The references cast q, k
    and v to fp32 first, so they are given the bf16 values as fp32 and
    compared before their own final rounding.  P rounded to one bf16
    instead uses more of that budget;
(b) the bf16 block geometry: shared memory a block within the card's for
    every row count a config's head dim takes, and a block per SM at the
    InternVL2-26B, Qwen1.5-MoE-A2.7B (1 x 4 local) and StableLM-1.6B CLI
    prefill shapes (every config at B = 2, S = 4,096 is in
    ``tests/test_torch_kernels.py``);
(c) the bf16 operand contract (``check_bf16_operands``), which every
    config's ``_project_qkv`` outputs and fused-buffer views meet.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops, ref  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models.layers import init_tree, rope_freqs  # noqa: E402

ULP = 2.0 ** -8              # one bf16 ulp of a value's scale, as the card's
                             # 2-ulp check counts it
SMEM_PER_BLOCK = 232_448
KEY_TILE = 64
BLOCK_ROWS = 64              # a consumer warpgroup's rows


def _bf16(x):
    return x.to(torch.bfloat16).float()


def emulate(q, k, v, *, causal=True, window=0, split=True, store=True):
    """The bf16 kernel's arithmetic on fp32 tensors holding bf16 values:
    per (batch, KV head), blocks of BLOCK_ROWS flattened rows (row f is
    position f // g, head f % g), each over the KEY_TILE-key tiles of its
    rows' key range; S = Q K^T in fp32 scaled by log2(e) / sqrt(hd); masked
    scores NEG_INF; m, l and O in fp32 with exp2; P V as bf16(p) V +
    bf16(p - bf16(p)) V (``split``) or bf16(p) V alone; O / max(l, 1e-30),
    rounded to bf16 (``store``).  Returns (B, Sq, H, hd) fp32."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    g = H // K
    offset = Sk - Sq
    n_rows = Sq * g
    scale = 1.4426950408889634 / math.sqrt(hd)
    # (B, K, Sq * g, hd): the flattened rows of each (batch, KV head)
    qf = q.reshape(B, Sq, K, g, hd).permute(0, 2, 1, 3, 4).reshape(
        B, K, n_rows, hd)
    kt, vt = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)    # (B, K, Sk, hd)
    out = torch.empty_like(qf)
    for f0 in range(0, n_rows, BLOCK_ROWS):
        f_end = min(f0 + BLOCK_ROWS, n_rows)
        pos = torch.arange(f0, f_end) // g + offset
        lo_key = max(0, f0 // g + offset - window + 1) if window > 0 else 0
        hi_key = min(Sk - 1, (f_end - 1) // g + offset) if causal else Sk - 1
        rows = qf[:, :, f0:f_end]
        m = torch.full(rows.shape[:-1], fa.NEG_INF)
        l = torch.zeros(rows.shape[:-1])
        acc = torch.zeros(rows.shape)
        for k0 in range(lo_key // KEY_TILE * KEY_TILE, hi_key + 1, KEY_TILE):
            keys = torch.arange(k0, k0 + KEY_TILE)
            live = (keys[None, :] < Sk).expand(len(pos), -1).clone()
            if causal:
                live &= keys[None, :] <= pos[:, None]
            if window > 0:
                live &= pos[:, None] - keys[None, :] < window
            kk = torch.zeros(B, K, KEY_TILE, hd)
            vv = torch.zeros(B, K, KEY_TILE, hd)
            n = min(KEY_TILE, Sk - k0)
            kk[:, :, :n], vv[:, :, :n] = kt[:, :, k0:k0 + n], vt[:, :, k0:k0 + n]
            s = torch.where(live, (rows @ kk.transpose(-1, -2)) * scale,
                            torch.tensor(fa.NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            hi = _bf16(p)
            acc = acc * alpha[..., None] + hi @ vv
            if split:
                acc = acc + _bf16(p - hi) @ vv
            m = m_new
        out[:, :, f0:f_end] = acc / torch.clamp(l, min=1e-30)[..., None]
    o = out.reshape(B, K, Sq, g, hd).permute(0, 2, 1, 3, 4).reshape(
        B, Sq, H, hd)
    return _bf16(o) if store else o


def _inputs(case, seed=0):
    """q, k, v of ``case`` drawn with numpy and rounded to bf16, as fp32."""
    B, Sq, Sk, H, K, hd = case[:6]
    rng = np.random.default_rng(seed)
    return tuple(_bf16(torch.from_numpy(rng.normal(0, 1, s).astype(
        np.float32))) for s in ((B, Sq, H, hd), (B, Sk, K, hd),
                                (B, Sk, K, hd)))


# B, Sq, Sk, H, K, hd, causal, window: head dims 32, 64, 128, 256; groups
# 1, 2, 6; causal, windowed and bidirectional; Sq < Sk.  A bidirectional
# Sk is at most 128 or a multiple of it (the Pallas kernel's key blocks).
EMU_CASES = [
    (2, 100, 100, 12, 2, 32, True, 0),
    (1, 128, 128, 4, 4, 32, False, 0),
    (1, 150, 150, 8, 4, 64, True, 40),
    (2, 60, 200, 12, 2, 64, True, 0),
    (1, 130, 130, 6, 1, 128, True, 0),
    (2, 140, 140, 4, 4, 128, True, 70),
    (1, 96, 96, 8, 4, 128, False, 0),
    (1, 120, 120, 4, 4, 256, True, 50),
    (1, 90, 90, 4, 2, 256, True, 0),
    (1, 50, 256, 12, 2, 128, False, 0),
    (2, 70, 70, 12, 2, 64, False, 24),
]


@pytest.mark.parametrize("case", EMU_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_emulated_bf16_kernel_matches_oracle_and_pallas(case):
    """The emulated kernel's bf16 output is within 1 bf16 ulp of each
    reference's scale, and each element within half a bf16 ulp of itself
    (its rounding) plus ULP**2 of the scale; before the store its P split
    keeps it well inside what one bf16 P costs.  Against the port's plain
    version, rounded too, the card's checks hold: 2 ulps of the scale, and
    each element within one ulp of itself plus ULP**2 of the scale."""
    causal, window = case[6], case[7]
    q, k, v = _inputs(case)
    out = emulate(q, k, v, causal=causal, window=window)
    pre = emulate(q, k, v, causal=causal, window=window, store=False)
    one = emulate(q, k, v, causal=causal, window=window, split=False,
                  store=False)
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    for other in (ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                          window=window),
                  ops.flash_attention(jq, jk, jv, causal=causal,
                                      window=window)):
        want = torch.from_numpy(np.array(other))
        tol = ULP * float(want.abs().max())
        assert float((out - want).abs().max()) <= tol
        assert bool(((out - want).abs() <= ULP * want.abs()
                     + ULP * tol).all())
        assert float((pre - want).abs().max()) < float(
            (one - want).abs().max())
    # the port's plain version on the same bf16 tensors rounds its fp32
    # result the same way
    plain = fa.flash_attention_plain(q.to(torch.bfloat16),
                                     k.to(torch.bfloat16),
                                     v.to(torch.bfloat16), causal=causal,
                                     window=window).float()
    scale = float(plain.abs().max())
    assert float((out - plain).abs().max()) <= 2 * ULP * scale
    assert bool(((out - plain).abs() <= 2 * ULP * plain.abs()
                 + ULP * ULP * scale).all())


def test_single_bf16_p_uses_more_of_the_budget():
    """At a causal group of 6 over 2,048 keys (hd 128): before the store,
    P split into hi + lo uses under 1 % of the 1-ulp budget and one bf16 P
    over 10 % (~1e-3 of the output's scale); after it both are within the
    budget (the largest errors are the store's own rounding), and one bf16
    P rounds over 10 times as many outputs away from the rounded
    reference."""
    case = (1, 2048, 2048, 6, 1, 128, True, 0)
    q, k, v = _inputs(case, seed=1)
    want = torch.from_numpy(np.array(ref.flash_attention_ref(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=True)))
    tol = ULP * float(want.abs().max())
    pre = {split: emulate(q, k, v, split=split, store=False)
           for split in (True, False)}
    share = {split: float((o - want).abs().max()) / tol
             for split, o in pre.items()}
    assert share[True] < 0.01 and share[False] > 0.1
    off = {}
    for split, o in pre.items():
        assert float((_bf16(o) - want).abs().max()) <= tol
        off[split] = int((_bf16(o) != _bf16(want)).sum())
    assert off[False] > 10 * off[True]


# B, Sq, H, K, hd: InternVL2-26B's prefill, Qwen1.5-MoE-A2.7B's on one rank
# of 1 x 4 (4 local heads over 4), StableLM-1.6B's in the serving CLI.
BF16_PREFILLS = {"internvl2": (2, 4096, 48, 8, 128),
                 "qwen2_moe_local": (2, 1024, 4, 4, 128),
                 "stablelm_cli": (4, 64, 32, 32, 64)}


@pytest.mark.parametrize("name", sorted(BF16_PREFILLS))
def test_bf16_block_rule_fills_the_card(name):
    B, Sq, H, K, hd = BF16_PREFILLS[name]
    rows = fa.bf16_block_rows(B, Sq, H, K, hd)
    assert rows in fa.BF16_ROWS and rows <= fa.bf16_max_rows(hd)
    assert fa.bf16_blocks(B, Sq, H, K, rows) >= fa.NUM_SMS
    assert fa.bf16_smem_bytes(hd, rows) <= SMEM_PER_BLOCK
    if name == "internvl2":               # the full prompt takes full blocks
        assert rows == 128


def _project(arch):
    """A smoke-width config's q, k, v from ``_project_qkv`` in bf16 on the
    CPU (B = 2, S = 24)."""
    cfg = get_config(arch, smoke=True)
    gen = torch.Generator().manual_seed(0)
    p = init_tree(gen, t_attn.attention_specs(cfg), torch.bfloat16)
    x = torch.randn(2, 24, cfg.d_model, generator=gen).to(torch.bfloat16)
    positions = torch.arange(24, dtype=torch.int32)
    return cfg, t_attn._project_qkv(
        cfg, p, x, positions, rope_freqs(cfg, cfg.resolved_head_dim))


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_bf16_contract_admits_every_config(arch):
    """Every config's smoke-width projections, and views of a fused
    (B, S, H + 2K, hd) buffer at its full-width heads and head dim, meet
    the bf16 kernel's contract."""
    cfg, (q, k, v) = _project(arch)
    assert q.dtype == k.dtype == v.dtype == torch.bfloat16
    fa.check_bf16_operands(q, k, v)
    full = get_config(arch)
    H, K, hd = full.num_heads, full.num_kv_heads, full.resolved_head_dim
    assert hd % 8 == 0 and hd <= fa.MAX_HEAD_DIM
    fused = torch.zeros(1, 3, H + 2 * K, hd, dtype=torch.bfloat16)
    fa.check_bf16_operands(fused[:, :, :H], fused[:, :, H:H + K],
                           fused[:, :, H + K:])


@pytest.mark.parametrize("bad", ["hd_12", "hd_4", "misaligned_start",
                                 "odd_head_stride", "strided_last_dim"])
def test_bf16_contract_refuses(bad):
    """What the tensor maps and 16-byte loads cannot take raises."""
    B, S, H, K, hd = 2, 16, 4, 2, 64
    q = torch.zeros(B, S, H, hd, dtype=torch.bfloat16)
    k = torch.zeros(B, S, K, hd, dtype=torch.bfloat16)
    v = torch.zeros(B, S, K, hd, dtype=torch.bfloat16)
    if bad.startswith("hd_"):
        d = int(bad[3:])
        q, k, v = q[..., :d], k[..., :d], v[..., :d]
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    elif bad == "misaligned_start":
        # a view from element 4: 8 bytes past a 16-byte boundary
        k = torch.zeros(B * S * K * hd + 4, dtype=torch.bfloat16)[4:].view(
            B, S, K, hd)
    elif bad == "odd_head_stride":
        # heads 68 elements apart (136 bytes): not a multiple of 16 bytes
        v = torch.zeros(B, S, K, 68, dtype=torch.bfloat16)[..., :hd]
    else:
        q = torch.zeros(B, S, H, 2 * hd, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError):
        fa.check_bf16_operands(q, k, v)
