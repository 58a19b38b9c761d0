"""The metric arithmetic on fixed inputs, held to hand-reckoned values."""
import json

import pytest

from costs import kernels as kc
from costs import models as cm
from harness import bench, stats, trace

LENET = {"image_size": 28, "in_channels": 1, "num_classes": 10,
         "conv_channels": [6, 16], "kernel_size": 5, "fc_dims": [120, 84]}


def test_union_counts_overlaps_once_and_clips():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 50)]
    assert stats.union_length(iv) == 15 + 10 + 10
    assert stats.union_length(iv, 8, 45) == 7 + 10 + 5
    assert stats.union_length([]) == 0
    assert stats.gaps_between(iv, 0, 60) == [(15, 20), (30, 40), (50, 60)]


def test_idle_share_and_busy_of_a_slice():
    tr = {"lo": 0.0, "hi": 100.0, "host": [],
          "kernels": [("a", 10.0, 30.0), ("b", 20.0, 40.0), ("c", 90.0,
                                                              120.0)]}
    busy, window = trace.busy_window_s(tr)
    assert busy == pytest.approx(40e-6) and window == pytest.approx(100e-6)
    assert trace.idle_share(tr) == pytest.approx(60.0)
    assert trace.kernel_times_us(tr, "b") == [20.0]
    tr["spans"] = {"pb.x": [(0.0, 35.0, 7.0), (80.0, 100.0, 1.0)]}
    assert trace.span_union_us(tr, "pb.x") == pytest.approx(25.0 + 10.0)
    assert trace.span_device_us(tr, "pb.x") == pytest.approx(8.0)
    assert trace.span_union_us(tr, "pb.none") is None


def test_p95_over_all_gaps():
    gaps = [float(i) for i in range(1, 101)]          # 1 .. 100
    # inclusive linear quantile: 1 + 0.95 * 99
    assert stats.percentile(gaps, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    m = bench.metric_module("itl_p95_ms")
    assert m.value({"gaps_s": [g / 1e3 for g in gaps]}) == \
        pytest.approx(95.05)


def test_lenet_flops_by_hand():
    # conv1 24x24x6 outputs x 25 MACs, conv2 8x8x16 x 150, fc 256x120,
    # 120x84, 84x10; 2 FLOPs a MAC
    fwd = 2 * (24 * 24 * 6 * 25 + 8 * 8 * 16 * 150 + 256 * 120 + 120 * 84
               + 84 * 10)
    assert cm.lenet_forward_flops(LENET) == fwd == 563_280
    assert cm.lenet_train_flops(LENET) == 3 * fwd - 2 * 24 * 24 * 6 * 25
    r = cm.hfl_round_flops(LENET, 100, 649, 17, 8, 10_000 + 64_900)
    assert r == 136 * 64_900 * 1_517_040 + 74_900 * 563_280
    assert 13.3e12 < r < 13.5e12


QWEN = json.loads((bench.HERE / "configs" /
                   "qwen1.5-moe-a2.7b-bf16.json").read_text())


def test_qwen_flops_and_bytes_by_hand():
    c = QWEN
    d, f, fs = 2048, 1408, 5632
    per_token = (2 * d * 128 * (2 * 16 + 2 * 16) + 2 * d * 60
                 + 4 * 3 * 2 * d * f + 3 * 2 * d * fs + 2 * d)
    assert cm.moe_token_flops(c) == per_token
    pairs = 4096 * 4097 // 2
    pre = (4 * 4096 * 24 * per_token + 4 * 24 * 4 * 128 * 16 * pairs
           + 4 * 2 * d * 151_936)
    assert cm.prefill_flops(c, 4, 4096) == pre
    assert 74e12 < pre < 75e12
    step = 32 * (24 * (per_token + 4 * 128 * 16 * 1500) + 2 * d * 151_936)
    assert cm.decode_flops(c, 32, 1500) == step
    layer = d * 128 * 64 + 2 * d + d * 60 + 3 * d * fs + d
    weights = 24 * layer + d * 151_936 + d + 32 * d
    nbytes = 2 * (weights + 24 * 53 * 3 * d * f
                  + 24 * 2 * 32 * 16 * 128 * 1501)
    assert cm.decode_bytes(c, 32, 1500, 24 * 53) == nbytes


def test_kernel_bounds_by_hand():
    # K1 on the paper's buffer: 2 N F FLOPs, x read and the result written
    # (4 + 4 bytes an element), w and the group ids 8 bytes a row
    assert kc.segment_aggregate(100, 44_426) == (8_885_200,
                                                 35_540_800 + 800)
    assert kc.cloud_aggregate(100, 44_426)[1] == 35_540_800 + 400
    assert kc.bound_s(8_885_200, 35_541_600, "float32") == \
        pytest.approx(35_541_600 / 3.35e12)
    # K5 bf16 at the prefill cell: 4 hd FLOPs an unmasked pair
    fl, nb = kc.flash_attention(4, 4096, 16, 16, 128)
    assert fl == 4 * 128 * 4 * 16 * (4096 * 4097 // 2)
    assert nb == 2 * 4 * (4 * 4096 * 16 * 128)
    assert kc.bound_s(fl, nb, "bfloat16") == pytest.approx(fl / 989e12)
    # K7 bf16: counted slots' K and V, q and the output, slot positions
    fl, nb = kc.decode_attention(32, 16, 16, 128, 1500, 3072)
    assert fl == 4 * 32 * 16 * 128 * 1500
    assert nb == 2 * (2 * 32 * 16 * 128 * 1500 + 2 * 32 * 16 * 128) \
        + 4 * 3073
