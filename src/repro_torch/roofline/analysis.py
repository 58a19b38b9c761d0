"""Roofline terms of one step on an H100 (per GPU).

  compute term    = FLOPs / peak FLOP/s of the step's dtype
  memory term     = bytes / HBM rate, bracketed [analytic lower, walk upper]
  collective term = collective bytes / NVLink rate

Copied from the JAX package's ``repro/roofline/analysis.py``: the config
counts (``active_params``, ``model_flops``, ``min_bytes_per_chip``,
``_total_params``) unchanged on the port's configs, and ``roofline_report``
with the reference's arithmetic and output keys on the H100's constants
(``repro_torch.launch.mesh``).  Where the reference reads a compiled
program's HLO (``hlo_cost``), the port's counts come from a cost walk of
the step run on the card (``repro_torch.roofline.cost``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16,
                                     PEAK_FLOPS_FP32)

_PEAK = {torch.float32: PEAK_FLOPS_FP32, torch.bfloat16: PEAK_FLOPS_BF16}


def collective_bytes_from_trace(cost: dict) -> Dict[str, float]:
    """Collective bytes by kind, plus totals, from a cost walk's dict
    (``cost.analyze``): the keys of the reference's
    ``collective_bytes_from_hlo``, its ``hlo_`` keys holding the walk's
    FLOPs and bytes."""
    out = {k[len("coll_"):]: v for k, v in cost.items()
           if k.startswith("coll_")}
    out["total"] = cost["collective_bytes"]
    out["ops"] = cost["collective_ops"]
    out["hlo_flops"] = cost["flops"]
    out["hlo_bytes"] = cost["bytes"]
    return out


def record_from_trace(cost: dict) -> dict:
    """A cost walk's dict as a dry-run record in the reference's layout,
    ``{"cost": {"flops", "bytes_accessed"}, "collectives": ...}``:
    ``roofline_report``'s ``rec``."""
    return {"cost": {"flops": cost["flops"], "bytes_accessed": cost["bytes"]},
            "collectives": collective_bytes_from_trace(cost)}


def active_params(cfg) -> float:
    """Per-token ACTIVE parameter count (MoE: top-k + shared experts only)."""
    if hasattr(cfg, "image_size"):  # LeNet
        return 60_000.0
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    total = float(emb)
    for k in cfg.layer_kinds:
        attn = d * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
        if k in ("attn", "local_attn"):
            total += attn
            if cfg.is_moe and k == "attn":
                f = cfg.moe_d_ff or cfg.d_ff
                total += cfg.num_experts_per_tok * 3 * d * f
                total += cfg.num_shared_experts * 3 * d * f
                total += d * cfg.num_experts
            else:
                n_mat = 3 if cfg.act == "silu" else 2
                total += n_mat * d * cfg.d_ff
        elif k == "rglru":
            n_mat = 3 if cfg.act == "silu" else 2
            total += 5 * d * d + n_mat * d * cfg.d_ff
        elif k == "mlstm":
            total += 5 * d * d
        elif k == "slstm":
            total += 5 * d * d
    if cfg.encoder_decoder:
        n_mat = 3 if cfg.act == "silu" else 2
        for _ in range(cfg.num_encoder_layers):
            total += d * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
            total += n_mat * d * cfg.d_ff
        # cross attention in each decoder layer
        total += cfg.num_layers * d * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
    return total


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train / 2*N*D inference (MoE: N_active)."""
    n_active = active_params(cfg)
    if shape.kind == "train":
        if cfg.encoder_decoder:
            tokens = shape.global_batch * (shape.seq_len + shape.seq_len // cfg.decoder_len_ratio)
        else:
            tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # one token per sequence


def min_bytes_per_chip(cfg, shape, chips: int, *, dtype_bytes: int = 2) -> float:
    """Analytic LOWER bound on HBM traffic per chip per step.

    Train: params read + grads written + opt-state touch (3x param bytes,
    fp32 opt) + layer-boundary activations saved & re-read under remat
    (2 x B x S x D x L x dtype).  Inference: params read once + KV-cache
    traffic.  The walk's bytes (one round trip an aten op) are the
    matching UPPER bound; true traffic lands between them.
    """
    n = active_params(cfg) if not cfg.is_moe else _total_params(cfg)
    p_bytes = n * dtype_bytes / chips
    B, S = shape.global_batch, shape.seq_len
    D, L = cfg.d_model, cfg.num_layers
    if shape.kind == "train":
        opt = n * 4 * 3 / chips                      # mu, nu, fp32 master
        acts = 2.0 * B * S * D * L * dtype_bytes / chips
        return 3 * p_bytes + opt + acts
    if shape.kind == "prefill":
        acts = 2.0 * B * S * D * L * dtype_bytes / chips
        return p_bytes + acts
    # decode: params + one KV-cache read per step
    kv = 2.0 * B * S * cfg.num_kv_heads * cfg.resolved_head_dim * \
        len([k for k in cfg.layer_kinds if "attn" in k]) * dtype_bytes / chips
    return p_bytes + kv


def _total_params(cfg) -> float:
    """All-experts param count (storage), vs active_params (compute)."""
    base = active_params(cfg)
    if not cfg.is_moe:
        return base
    f = cfg.moe_d_ff or cfg.d_ff
    per_tok = (cfg.num_experts_per_tok + cfg.num_shared_experts) * 3 * cfg.d_model * f
    all_e = (cfg.num_experts + cfg.num_shared_experts) * 3 * cfg.d_model * f
    moe_layers = sum(1 for k in cfg.layer_kinds if k == "attn")
    return base + moe_layers * (all_e - per_tok)


def roofline_report(cfg, shape, rec: dict, chips: int = 1, *,
                    dtype=torch.bfloat16) -> dict:
    """Three roofline terms (seconds/step, per GPU) + bottleneck analysis.

    ``rec`` is a dry-run record in the reference's layout
    (``record_from_trace``): ``rec["cost"]`` (``flops``,
    ``bytes_accessed``) and ``rec["collectives"]`` (``total``, ``ops``,
    ``hlo_flops``, ``hlo_bytes``), the ``hlo_`` keys holding the cost
    walk's counts, so one record reads the same in both packages.  The
    compute term takes the peak of the step's ``dtype`` (fp32 off the
    tensor cores or bf16 on them; the reference always takes bf16), the
    memory bracket's lower bound that dtype's width, and the collective
    term the NVLink rate.  memory_s is the geometric mean of the
    [lower, upper] bracket: the upper bound is the walk's bytes (one
    round trip an aten op; fusion would move fewer), the lower bound the
    analytic params+activations minimum.
    """
    if dtype not in _PEAK:
        raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, "
                         f"got {dtype}")
    coll = rec["collectives"]
    flops_dev = coll.get("hlo_flops") or rec["cost"]["flops"]
    bytes_dev = coll.get("hlo_bytes") or rec["cost"]["bytes_accessed"]
    coll_bytes = coll.get("total", 0.0)
    t_compute = flops_dev / _PEAK[dtype]
    t_mem_hi = bytes_dev / HBM_BW
    t_mem_lo = min_bytes_per_chip(
        cfg, shape, chips, dtype_bytes=torch.finfo(dtype).bits // 8) / HBM_BW
    t_memory = float(np.sqrt(max(t_mem_lo, 1e-12) * max(t_mem_hi, 1e-12)))
    t_coll = coll_bytes / NVLINK_BW
    mf = model_flops(cfg, shape)
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    hlo_global = flops_dev * chips
    return {
        **terms,
        "memory_s_lower": t_mem_lo,
        "memory_s_upper": t_mem_hi,
        "dominant": dominant,
        "model_flops_global": mf,
        "hlo_flops_global": hlo_global,
        "useful_flops_ratio": (mf / hlo_global) if hlo_global else None,
        "step_time_lower_bound_s": max(terms.values()),
        "xla_cost_analysis_flops_unscaled": rec["cost"]["flops"],
    }
