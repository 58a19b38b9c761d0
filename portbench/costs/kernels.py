"""The least time each hand-written kernel could take for its shapes.

Frozen copies of the program's cost arithmetic
(``repro_torch/kernels/hier_aggregate.py::segment_aggregate_cost`` and
``cloud_aggregate_cost``, ``flash_attention.py::flash_attention_cost``,
``decode_attention.py::decode_attention_cost``), from shapes alone, so a
later change to the program cannot move the yardstick.  A roofline bound
is the larger of FLOPs over the peak of the arithmetic and bytes over the
HBM rate; each input byte is counted read once and each output byte
written once, and attention counts only the (query, key) pairs or cache
slots that these inputs need.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def bound_s(flops: float, nbytes: float, arithmetic: str) -> float:
    """Seconds at the roofline: max(FLOPs / peak, bytes / HBM rate)."""
    return max(flops / PEAKS["flops_per_s"][arithmetic],
               nbytes / PEAKS["hbm_bytes_per_s"])


def segment_aggregate(n: int, f: int, elem: int = 4) -> tuple:
    """K1 (eq. 6): x (n, f) and w, group ids read, (n, f) fp32 written."""
    return 2 * n * f, n * f * (elem + 4) + 8 * n


def cloud_aggregate(n: int, f: int, elem: int = 4) -> tuple:
    """K2 (eq. 10): x (n, f) and w read, (n, f) fp32 written."""
    return 2 * n * f, n * f * (elem + 4) + 4 * n


def causal_pairs(s: int) -> int:
    """Unmasked (query, key) pairs of one (row, head) of causal attention
    over ``s`` positions."""
    return s * (s + 1) // 2


def flash_attention(b: int, s: int, h: int, kv: int, hd: int,
                    elem: int = 2) -> tuple:
    """K5, causal prefill: 4 hd FLOPs an unmasked pair of each query head;
    q, k, v read once, the output (q's shape) written once."""
    pairs = b * h * causal_pairs(s)
    q = b * s * h * hd
    k = b * s * kv * hd
    return 4 * hd * pairs, elem * (2 * q + 2 * k)


def decode_attention(b: int, h: int, kv: int, hd: int, counted: int,
                     ring: int, elem: int = 2) -> tuple:
    """K7, one token a row: 4 hd FLOPs a counted slot of each query head;
    the counted slots' K and V rows, q, the output, the ring's slot
    positions and the position moved once."""
    q = b * h * hd
    return (4 * b * h * hd * counted,
            elem * (2 * b * kv * hd * counted + 2 * q) + 4 * (ring + 1))
