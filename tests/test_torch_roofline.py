"""The port's roofline bridge (``repro_torch.roofline``) against the JAX
package's (``repro.roofline``), on the CPU.

* The numpy half exactly: ``active_params``, ``model_flops``,
  ``min_bytes_per_chip`` and ``_total_params`` of the ten architectures
  at full width over the four ``INPUT_SHAPES``; ``roofline_report`` on
  one shared record against the reference's with the reference module's
  constants set to the H100's (``monkeypatch``; no file changes).
* The cost walk's FLOPs (``cost.analyze``) of the port's train step
  (AdamW), prefill and greedy decode step against the reference's
  trip-count-aware HLO walk (``hlo_cost.analyze``) of the jitted
  counterparts, every architecture at smoke width, ``xla_flash``, the
  reference's weights carried across.  They are equal except where the
  two programs do different products; each such difference is asserted
  as an exact, named amount (``FLOP_DIFFERENCE``).
* The walk's bytes and collectives on hand-reckoned cases (an all-reduce
  on 2 gloo ranks), the kernels' cost functions against the counts their
  bounds were printed with on the card, and the walk's refusal of a
  launch whose cost was not recorded.

The all-reduce's ranks run ``_all_reduce_rank``: ``spawn`` imports this
module in each, so JAX is imported only inside the tests.
"""
import copy
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.configs.lenet_mnist import LeNetConfig  # noqa: E402
from repro_torch.kernels import costs  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import hier_aggregate as ha  # noqa: E402
from repro_torch.kernels import rglru_scan as rs  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.roofline import analysis as t_an  # noqa: E402
from repro_torch.roofline import cost as t_cost  # noqa: E402

B, S = 4, 64                    # the FLOP parity's batch and sequence


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the numpy half ---------------------------------------------------------------

@pytest.mark.parametrize("shape", list(t_base.INPUT_SHAPES))
@pytest.mark.parametrize("arch", list(t_base.ARCH_IDS) + ["lenet"])
def test_config_counts_equal_reference(arch, shape):
    """Every count of the numpy half equals the reference's exactly
    (LeNet: ``active_params`` alone, as the reference knows it)."""
    from repro.configs import base as j_base
    from repro.configs.lenet_mnist import LeNetConfig as JLeNet
    from repro.roofline import analysis as j_an
    if arch == "lenet":
        assert t_an.active_params(LeNetConfig()) == \
            j_an.active_params(JLeNet())
        return
    t_cfg, j_cfg = t_base.get_config(arch), j_base.get_config(arch)
    t_shp, j_shp = t_base.INPUT_SHAPES[shape], j_base.INPUT_SHAPES[shape]
    assert t_an.active_params(t_cfg) == j_an.active_params(j_cfg)
    assert t_an._total_params(t_cfg) == j_an._total_params(j_cfg)
    assert t_an.model_flops(t_cfg, t_shp) == j_an.model_flops(j_cfg, j_shp)
    for chips in (1, 256):
        for width in (2, 4):
            assert t_an.min_bytes_per_chip(t_cfg, t_shp, chips,
                                           dtype_bytes=width) == \
                j_an.min_bytes_per_chip(j_cfg, j_shp, chips,
                                        dtype_bytes=width)


class _Mesh:
    def __init__(self, chips):
        self.shape = {"data": chips}


@pytest.mark.parametrize("chips", [1, 4])
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_roofline_report_equals_reference_under_h100_constants(
        monkeypatch, dtype, chips):
    """One record, read by both reports: the reference's (its module's
    peak, HBM and link constants set to the H100's; at fp32 its peak set
    to the fp32 peak and its byte bound given the fp32 width) equals the
    port's key for key."""
    from repro.configs import base as j_base
    from repro.roofline import analysis as j_an
    rec = {"cost": {"flops": 3.0e15, "bytes_accessed": 2.5e11},
           "collectives": {"all-reduce": 4.0e9, "total": 4.0e9, "ops": 12,
                           "hlo_flops": 1.1e16, "hlo_bytes": 9.5e11}}
    monkeypatch.setattr(j_an, "HBM_BW", t_mesh.HBM_BW)
    monkeypatch.setattr(j_an, "ICI_BW", t_mesh.NVLINK_BW)
    if dtype == "bf16":
        monkeypatch.setattr(j_an, "PEAK_FLOPS_BF16", t_mesh.PEAK_FLOPS_BF16)
        t_dtype = torch.bfloat16
    else:
        monkeypatch.setattr(j_an, "PEAK_FLOPS_BF16", t_mesh.PEAK_FLOPS_FP32)
        monkeypatch.setattr(j_an, "min_bytes_per_chip", functools.partial(
            j_an.min_bytes_per_chip, dtype_bytes=4))
        t_dtype = torch.float32
    for arch, shape in (("stablelm-1.6b", "train_4k"),
                        ("qwen2-moe-a2.7b", "decode_32k")):
        got = t_an.roofline_report(t_base.get_config(arch),
                                   t_base.INPUT_SHAPES[shape], rec, chips,
                                   dtype=t_dtype)
        want = j_an.roofline_report(j_base.get_config(arch),
                                    j_base.INPUT_SHAPES[shape], rec,
                                    _Mesh(chips))
        assert got == want


def test_record_from_trace_reads_as_the_reference_record():
    cost = {"flops": 7.0, "bytes": 11.0, "collective_bytes": 5.0,
            "collective_ops": 2, "coll_all-reduce": 5.0,
            "coll_all-gather": 0.0, "kernels": {}}
    rec = t_an.record_from_trace(cost)
    assert rec == {"cost": {"flops": 7.0, "bytes_accessed": 11.0},
                   "collectives": {"all-reduce": 5.0, "all-gather": 0.0,
                                   "total": 5.0, "ops": 2,
                                   "hlo_flops": 7.0, "hlo_bytes": 11.0}}


# -- FLOPs: the cost walk against the reference's HLO walk ---------------------------

def _moe_gate_outer(cfg):
    """The MoE's shared-expert gate, a (D, 1) product (``models/moe.py``,
    the reference's ``moe.py:147``): its input gradient is an outer
    product dy (T, 1) @ W^T (1, D) of contraction 1, which XLA rewrites
    into a multiply and so counts no dot.  One a layer, 2 T D FLOPs."""
    return cfg.num_layers * 2 * (B * S) * cfg.d_model


def _xlstm_cells(cfg):
    """Two cell products.  (1) The mLSTM cell's C q product (``bhvk,bhk``):
    its gradient with respect to C is an outer product dh q^T of
    contraction 1, a multiply in XLA, one a step: + S 2 B H hd^2 a mLSTM
    layer.  (2) The sLSTM's recurrent product (``bhk,hktj``): at step 0
    its input is the zero initial state, which needs no gradient, so
    autograd skips that product's input gradient while XLA's loop body
    computes it on every trip: - 2 B H_s hd_s 4 hd_s an sLSTM layer."""
    hd = cfg.resolved_head_dim
    hs = cfg.d_model // cfg.slstm_heads
    kinds = cfg.layer_kinds
    return (kinds.count("mlstm") * S * 2 * B * cfg.num_heads * hd * hd
            - kinds.count("slstm") * 2 * B * cfg.slstm_heads * hs * 4 * hs)


def _whisper_remat(cfg):
    """Rematerialisation the reference's compiled step does not repeat.
    (1) Each decoder block's cross-attention K and V projections of the
    encoder output (``attention.encode_kv``): the port computes them in
    the forward pass and again in the block's recompute
    (``torch.utils.checkpoint``), the reference's program once, 2 x 2 B S
    D^2 a decoder layer.  (2) One encoder block, whatever the encoder's
    depth (1, 2 or 3 layers give the same amount): its q, k, v and output
    projections (4 x 2 B S D^2) and its two attention products (2 x 2 B H
    S^2 hd) run once in the reference's program, in the forward pass and
    the recompute in the port's.  Without remat the counts are equal."""
    d, hd, H = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads
    proj = 2 * B * S * d * d
    return ((2 * cfg.num_layers + 4) * proj
            + 2 * (2 * B * H * S * S * hd))


#: (arch, step) -> the port's FLOPs less the reference's, by its cause.
FLOP_DIFFERENCE = {("qwen2-moe-a2.7b", "train"): _moe_gate_outer,
                   ("xlstm-125m", "train"): _xlstm_cells,
                   ("whisper-base", "train"): _whisper_remat}


@functools.lru_cache(maxsize=1)
def _pair(arch):
    """The reference's smoke model and params, the port's on the CPU with
    the same params, and a (B, S) training batch (numpy)."""
    import jax
    from repro.configs import base as j_base
    from repro.models.model import Model as JModel
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch import train
    from repro_torch.models.model import Model as TModel
    from repro_torch.weights import from_jax_params
    j_cfg = j_base.get_config(arch, smoke=True)
    t_cfg = t_base.get_config(arch, smoke=True)
    jm = JModel(j_cfg, impl="xla_flash")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    tm = TModel(t_cfg, impl="xla_flash", device="cpu")
    batch = train.batch_for(tm, TokenStream(t_cfg.vocab_size, seed=0), B, S,
                            0)
    return jm, jp, tm, tp, {k: v.numpy() for k, v in batch.items()}


def _reference_flops(jm, jp, batch, step):
    import jax
    import jax.numpy as jnp
    from repro.launch import steps as j_steps
    from repro.optim import adamw
    from repro.roofline import hlo_cost
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    prompt = {k: v for k, v in jb.items() if k != "targets"}
    if step == "train":
        opt = adamw(3e-4)
        low = jax.jit(j_steps.make_train_step(jm, opt)).lower(
            jp, opt.init(jp), jb)
    elif step == "prefill":
        low = jax.jit(jm.prefill).lower(jp, prompt)
    else:
        _, state = jax.jit(jm.prefill)(jp, prompt)
        low = jax.jit(j_steps.make_serve_step(jm)).lower(
            jp, state, jnp.zeros((B, 1), jnp.int32))
    return hlo_cost.analyze(low.compile().as_text())["flops"]


def _port_flops(tm, tp, batch, step):
    from repro_torch.launch import steps as t_steps
    from repro_torch.optim import adamw
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    prompt = {k: v for k, v in tb.items() if k != "targets"}
    if step == "train":
        opt = adamw(3e-4)
        params = copy.deepcopy(tp)      # the step writes into its params
        return t_cost.analyze(t_steps.make_train_step(tm, opt), params,
                              opt.init(params), tb)["flops"]
    with torch.no_grad():
        if step == "prefill":
            return t_cost.analyze(tm.prefill, tp, prompt)["flops"]
        _, state = tm.prefill(tp, prompt)
        return t_cost.analyze(t_steps.make_serve_step(tm), tp, state,
                              torch.zeros((B, 1), dtype=torch.int32))["flops"]


@pytest.mark.parametrize("step", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", list(t_base.ARCH_IDS))
def test_walk_flops_equal_reference_hlo_walk(arch, step):
    jm, jp, tm, tp, batch = _pair(arch)
    got = _port_flops(tm, tp, batch, step)
    want = _reference_flops(jm, jp, batch, step)
    diff = FLOP_DIFFERENCE.get((arch, step), lambda cfg: 0)(tm.cfg)
    assert got - want == diff, (arch, step, got, want)
    assert got > 0


# -- bytes, collectives, kernels -----------------------------------------------------

def test_walk_bytes_of_an_elementwise_chain():
    """Three elementwise ops on N floats: each reads N and writes N."""
    x = torch.randn(1000)
    c = t_cost.analyze(lambda: x.neg().exp().sin())
    assert c["bytes"] == 3 * 2 * 4 * 1000
    assert c["flops"] == 0 and c["collective_bytes"] == 0
    assert c["kernels"] == {}


def test_walk_views_are_free():
    x = torch.randn(32, 48)
    c = t_cost.analyze(lambda: (x.view(-1), x.t(), x.expand(2, 32, 48),
                                x.detach(), x[1:], x.unsqueeze(0),
                                x.reshape(48, 32), x.as_strided((4,), (1,))))
    assert c["bytes"] == 0 and c["flops"] == 0


def test_walk_counts_a_matmul():
    m, k, n = 24, 40, 56
    a, b = torch.randn(m, k), torch.randn(k, n)
    c = t_cost.analyze(torch.mm, a, b)
    assert c["flops"] == 2 * m * k * n
    assert c["bytes"] == 4 * (m * k + k * n + m * n)


ALL_REDUCE_N = 12_345


def _all_reduce_rank():
    import torch.distributed as dist
    x = torch.ones(ALL_REDUCE_N) * (dist.get_rank() + 1)
    c = t_cost.analyze(dist.all_reduce, x)
    return c, float(x[0])


def test_walk_counts_an_all_reduce_on_two_ranks():
    for c, total in run_ranks(_all_reduce_rank, 2, device="cpu",
                              timeout_s=120):
        assert total == 3.0
        assert c["collective_ops"] == 1
        assert c["coll_all-reduce"] == 4 * ALL_REDUCE_N
        assert c["collective_bytes"] == 4 * ALL_REDUCE_N
        assert all(c[f"coll_{k}"] == 0 for k in t_cost.COLL_KINDS
                   if k != "all-reduce")
        assert c["flops"] == 0


def test_walk_on_one_rank_has_no_collective():
    c = t_cost.analyze(torch.mm, torch.randn(8, 8), torch.randn(8, 8))
    assert c["collective_bytes"] == 0 and c["collective_ops"] == 0
    assert sorted(k for k in c if k.startswith("coll_")) == sorted(
        f"coll_{k}" for k in t_cost.COLL_KINDS)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _attn(B_, S_, H, K, hd, dtype=torch.float32):
    return _meta(B_, S_, H, hd, dtype=dtype), _meta(B_, S_, K, hd,
                                                    dtype=dtype)


@pytest.mark.parametrize("case, causal, pairs, hd", [
    ((2, 4096, 32, 2, 128), True, 537_001_984, 128),         # ChatGLM3
    ((2, 4096, 48, 8, 128, torch.bfloat16), True, 805_502_976, 128),
    ((8, 1500, 8, 8, 64), False, 144_000_000, 64),           # Whisper
])
def test_flash_attention_cost_counts_the_unmasked_pairs(case, causal, pairs,
                                                        hd):
    """K5's FLOPs: unmasked (query, key) pairs x 4 hd, the counts of its
    bounds at ChatGLM3's, InternVL2's and Whisper's prefill shapes; and
    the pairs equal ``attention_mask``'s on a windowed case."""
    q, kv = _attn(*case)
    flops, nbytes = fa.flash_attention_cost(q, kv, kv, causal=causal)
    assert flops == pairs * 4 * hd
    assert nbytes == q.element_size() * (2 * q.numel() + 2 * kv.numel())
    for sq, sk, c, w in ((300, 300, True, 64), (100, 300, True, 0),
                         (100, 300, False, 50), (7, 7, False, 0)):
        assert fa.unmasked_pairs(sq, sk, c, w) == int(
            fa.attention_mask(sq, sk, c, w).sum())


@pytest.mark.parametrize("case, nbytes", [
    ((2, 8192, 16, 16, 128, 4097, torch.float32), 134_316_036),   # MoE
    ((2, 8192, 48, 8, 128, 4097, torch.bfloat16), 33_644_548),    # InternVL2
    ((8, 187, 8, 8, 64, 32, torch.float32), 1_082_096),           # Whisper
])
def test_decode_attention_cost_counts_the_slots_that_count(case, nbytes):
    Bq, W, H, K, hd, n, dtype = case
    sp = torch.full((W,), -10**9, dtype=torch.int32)
    sp[:n] = torch.arange(n, dtype=torch.int32)
    pos = torch.tensor(n - 1, dtype=torch.int32)
    q, kv = _meta(Bq, 1, H, hd, dtype=dtype), _meta(Bq, W, K, hd,
                                                     dtype=dtype)
    flops, got = da.decode_attention_cost(q, kv, kv, sp, pos)
    assert got == nbytes
    assert flops == 4 * Bq * H * hd * n


def test_the_other_kernel_costs_read_inputs_once_and_write_once():
    x, w, g = _meta(100, 44_426), _meta(100), _meta(100, dtype=torch.int32)
    n, f = x.shape
    assert ha.segment_aggregate_cost(x, w, g, 5) == (2 * n * f,
                                                     8 * n * f + 8 * n)
    assert ha.cloud_aggregate_cost(x, w) == (2 * n * f, 8 * n * f + 4 * n)
    assert ha.weighted_mean_cost(x, w) == (2 * n * f,
                                           4 * n * f + 4 * n + 4 * f)
    assert ha.segment_sum_cost(x, w, g, 5) == (2 * n * f, 4 * n * f + 8 * n
                                               + 2 * 4 * 5 * f)
    a = _meta(2, 4096, 4096)
    assert rs.rglru_scan_cost(a, a) == (2 * a.numel(), 12 * a.numel())


def test_an_uncounted_launch_raises():
    """A wrapper whose ``launch_counts`` rises without ``costs.record``
    fails the walk; one that records passes and is counted."""
    q, kv = torch.randn(1, 8, 4, 16), torch.randn(1, 8, 2, 16)

    def stub_uncounted():
        fa.launch_counts["flash_attention"] += 1

    def stub_counted():
        fa.launch_counts["flash_attention"] += 1
        costs.record("flash_attention", fa.flash_attention_cost, q, kv, kv,
                     causal=True)

    before = dict(fa.launch_counts)
    try:
        with pytest.raises(RuntimeError, match="flash_attention launched 1"):
            t_cost.analyze(stub_uncounted)
        c = t_cost.analyze(stub_counted)
    finally:
        fa.launch_counts.update(before)
    flops, nbytes = fa.flash_attention_cost(q, kv, kv, causal=True)
    assert c["kernels"] == {"flash_attention": {
        "launches": 1, "flops": flops, "bytes": nbytes}}
    assert c["flops"] == flops and c["bytes"] == nbytes
    assert costs.walks == []
