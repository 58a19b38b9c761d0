"""Composable transformer stack, ported from the JAX package's
``repro/models/transformer.py`` for the layer kinds ``attn``,
``local_attn`` and ``rglru`` in the ``"layers"``-list layout (a python
loop over per-layer parameter dicts).

Not ported yet; each raises ``NotImplementedError`` (ROADMAP Queue 1 item
14): MoE layers, the xLSTM kinds ``mlstm`` and ``slstm``, the
encoder-decoder stack and the homogeneous ``"scanned"`` layout (stacked
parameters, one ``lax.scan`` over layers in the reference).
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.models import attention as attn
from repro_torch.models import recurrent as rec
from repro_torch.models.layers import (apply_mlp, apply_norm, mlp_specs,
                                       norm_specs)

_ITEM = "ROADMAP Queue 1 item 14"


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               f"({_ITEM})")


def _check_kind(cfg, kind: str):
    if kind in ("mlstm", "slstm"):
        raise _not_ported(f"the xLSTM layer kind {kind!r}")
    if kind not in ("attn", "local_attn", "rglru"):
        raise ValueError(kind)
    if cfg.is_moe and kind == "attn":
        raise _not_ported("the MoE layer")


def _check_stack(cfg):
    if cfg.encoder_decoder:
        raise _not_ported("the encoder-decoder stack")
    if cfg.homogeneous:
        raise _not_ported("the homogeneous 'scanned' layer layout")


def _window(cfg, kind: str) -> int:
    return cfg.sliding_window if kind == "attn" else cfg.local_window


# --------------------------------------------------------------------------
# Per-layer specs
# --------------------------------------------------------------------------

def block_specs(cfg, kind: str):
    _check_kind(cfg, kind)
    s: Dict[str, Any] = {"ln1": norm_specs(cfg)}
    if kind in ("attn", "local_attn"):
        s["attn"] = attn.attention_specs(cfg)
    else:
        s["rnn"] = rec.rglru_specs(cfg)
    s["ln2"] = norm_specs(cfg)
    s["mlp"] = mlp_specs(cfg)
    return s


# --------------------------------------------------------------------------
# Per-layer forward (full sequence)
# --------------------------------------------------------------------------

def apply_block(cfg, kind, p, x, *, impl="kernel"):
    """Full-sequence block.  Returns x."""
    _check_kind(cfg, kind)
    if kind in ("attn", "local_attn"):
        x = x + attn.self_attention(cfg, p["attn"],
                                    apply_norm(cfg, p["ln1"], x), causal=True,
                                    window=_window(cfg, kind), impl=impl)
    else:
        x = x + rec.apply_rglru(cfg, p["rnn"], apply_norm(cfg, p["ln1"], x),
                                impl=impl)
    return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))


# --------------------------------------------------------------------------
# Per-layer decode (one token, stateful)
# --------------------------------------------------------------------------

def init_layer_state(cfg, kind, batch: int, max_len: int, device=None):
    _check_kind(cfg, kind)
    if kind in ("attn", "local_attn"):
        window = _window(cfg, kind)
        W = min(window, max_len) if window > 0 else max_len
        return attn.init_kv_cache(cfg, batch, W, device=device)
    return rec.rglru_init_state(cfg, batch, device=device)


def prefill_block(cfg, kind, p, x, *, cache_len, impl="kernel"):
    """Full-sequence block that also returns the decode state (prefill)."""
    _check_kind(cfg, kind)
    if kind in ("attn", "local_attn"):
        h, st = attn.self_attention_prefill(
            cfg, p["attn"], apply_norm(cfg, p["ln1"], x), causal=True,
            window=_window(cfg, kind), impl=impl, cache_len=cache_len)
    else:
        h, st = rec.apply_rglru(cfg, p["rnn"], apply_norm(cfg, p["ln1"], x),
                                impl=impl, return_state=True)
    x = x + h
    return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x)), st


def prefill_stack(cfg, p, x, *, cache_len, impl="kernel"):
    """Full-sequence stack returning (x, decode_state) — the prefill path."""
    _check_stack(cfg)
    states = []
    for kind, lp in zip(cfg.layer_kinds, p["layers"]):
        x, st = prefill_block(cfg, kind, lp, x, cache_len=cache_len,
                              impl=impl)
        states.append(st)
    return x, {"layers": states}


def decode_block(cfg, kind, p, x, state):
    _check_kind(cfg, kind)
    if kind in ("attn", "local_attn"):
        h, state = attn.decode_self_attention(
            cfg, p["attn"], apply_norm(cfg, p["ln1"], x), state,
            window=_window(cfg, kind))
    else:
        h, state = rec.rglru_decode_step(cfg, p["rnn"],
                                         apply_norm(cfg, p["ln1"], x), state)
    x = x + h
    return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x)), state


# --------------------------------------------------------------------------
# Stack
# --------------------------------------------------------------------------

def stack_specs_tree(cfg):
    _check_stack(cfg)
    return {"layers": [block_specs(cfg, k) for k in cfg.layer_kinds]}


def init_stack_state(cfg, batch: int, max_len: int, device=None):
    _check_stack(cfg)
    return {"layers": [init_layer_state(cfg, k, batch, max_len, device)
                       for k in cfg.layer_kinds]}


def decode_stack(cfg, p, x, state):
    """One-token decode through the stack.  Returns (x, new_state)."""
    _check_stack(cfg)
    new_states = []
    for kind, lp, ls in zip(cfg.layer_kinds, p["layers"], state["layers"]):
        x, ns = decode_block(cfg, kind, lp, x, ls)
        new_states.append(ns)
    return x, {"layers": new_states}
