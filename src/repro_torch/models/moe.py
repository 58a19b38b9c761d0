"""Mixture-of-Experts FFN: top-k routing, capacity dispatch, shared experts.
Ported from the JAX package's ``repro/models/moe.py`` for one device
(``apply_moe(mesh=None)``).

Tokens are flattened batch-major, ``(B*S, D)``; each picks its top-k
experts by router probability, and the picks are dealt, token after token
and within a token in ``topk``'s descending order, into per-expert
capacity bins of ``C`` rows (``_capacity``, from ``T = B*S`` of the whole
call).  A pick past its expert's ``C`` rows is dropped: it is written to
the overflow row ``E*C``, which the expert products never read and whose
output row is zeros, so a dropped pick adds nothing and gets a zero
gradient.  The expert products are dense over all ``E*C`` rows.

Every op is out of place and has a batching rule (the one-hot is a
comparison with ``arange(E)``), so ``torch.func.vmap(grad)`` of a loss
through it goes through (``launch/train.py --mode hfl``).

With a mesh the reference shards the experts' hidden dim or the experts
themselves (``shard_map``, ``psum``, ``all_to_all``); that is ROADMAP
Queue 1 item 13c, and ``apply_moe`` raises ``NotImplementedError`` for it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import Spec, act_fn, matmul

# Capacity rounding granularity (the reference's, MXU-friendly there).
_CAP_ALIGN = 8


def moe_specs(cfg):
    d = cfg.d_model
    f = cfg.moe_d_ff or cfg.d_ff
    E = cfg.num_experts
    s = {
        "router": Spec((d, E), ("embed_nofsdp", "expert")),
        "w_gate": Spec((E, d, f), ("expert", "embed", "expert_mlp")),
        "w_up": Spec((E, d, f), ("expert", "embed", "expert_mlp")),
        "w_down": Spec((E, f, d), ("expert", "expert_mlp", "embed"), fan_in=f),
    }
    if cfg.num_shared_experts > 0:
        fs = cfg.num_shared_experts * f
        s["shared"] = {
            "wi_gate": Spec((d, fs), ("embed", "mlp")),
            "wi_up": Spec((d, fs), ("embed", "mlp")),
            "wo": Spec((fs, d), ("mlp", "embed")),
            "gate": Spec((d, 1), ("embed_nofsdp", None)),
        }
    return s


def _capacity(T: int, E: int, k: int, cf: float) -> int:
    c = int(math.ceil(k * T / E * cf))
    return max(_CAP_ALIGN, (c + _CAP_ALIGN - 1) // _CAP_ALIGN * _CAP_ALIGN)


def _one_hot(idx, n: int, dtype):
    """One-hot of ``idx`` over ``n`` classes, a comparison with
    ``arange(n)`` (vmap-safe)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def router_probs(router_w, xt):
    """The router's float32 logits and softmax probabilities, (T, E)."""
    logits = matmul(xt, router_w).to(torch.float32)
    return logits, torch.softmax(logits, -1)


def _route(cfg, router_w, xt):
    """xt: (T, D) -> gates (T,k), experts (T,k), aux losses."""
    logits, probs = router_probs(router_w, xt)
    top_p, top_e = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    # Switch-style load-balance loss + router z-loss.
    E = cfg.num_experts
    me = probs.mean(0)                                     # mean gate per expert
    ce = _one_hot(top_e, E, torch.float32).sum(1).mean(0) \
        / cfg.num_experts_per_tok
    aux = E * torch.sum(me * ce)
    z = torch.mean(torch.logsumexp(logits, -1) ** 2)
    return top_p.to(xt.dtype), top_e, aux, z


def _dispatch(xt, top_e, k: int, E: int, C: int):
    """Scatter tokens into per-expert capacity bins.

    Returns buf (E*C+1, D) [last row = overflow], dst (T*k,), keep (T*k,).
    """
    T, D = xt.shape
    e_flat = top_e.reshape(-1)                             # (T*k,) token-major
    pos = torch.cumsum(_one_hot(e_flat, E, torch.int32), 0) - 1  # (T*k, E)
    pos_in_e = torch.gather(pos, 1, e_flat[:, None])[:, 0]
    keep = pos_in_e < C
    dst = torch.where(keep, e_flat * C + pos_in_e,
                      torch.full_like(e_flat, E * C))
    src = torch.arange(T * k, device=xt.device) // k
    buf = torch.zeros((E * C + 1, D), dtype=xt.dtype, device=xt.device)
    buf = torch.index_put(buf, (dst,), xt[src])
    return buf, dst, keep


def _expert_ffn(cfg, p, buf, E: int, C: int):
    """buf (E*C+1, D) -> (E*C+1, D), the overflow row's output zeros."""
    a = act_fn(cfg.act)
    eb = buf[: E * C].reshape(E, C, -1)
    h = a(matmul(eb, p["w_gate"])) * matmul(eb, p["w_up"])
    out = matmul(h, p["w_down"]).reshape(E * C, -1)
    return torch.cat([out, torch.zeros_like(out[:1])], 0)


def _combine(out_buf, dst, top_p, T: int, k: int):
    y = out_buf[dst]                                       # (T*k, D); overflow->0
    y = y * top_p.reshape(-1)[:, None].to(y.dtype)
    return y.reshape(T, k, -1).sum(1)


def _local_moe(cfg, p, x):
    """The routed experts of one device.  x: (B, S, D)."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    C = _capacity(T, E, k, cfg.capacity_factor)
    top_p, top_e, aux, z = _route(cfg, p["router"], xt)
    buf, dst, _ = _dispatch(xt, top_e, k, E, C)
    out_buf = _expert_ffn(cfg, p, buf, E, C)
    y = _combine(out_buf, dst, top_p, T, k)
    return y.reshape(B, S, D), cfg.router_aux_loss * aux + 1e-3 * z


def apply_moe(cfg, p, x, mesh=None, rules=None):
    """MoE FFN.  Returns (y, aux_loss).  x: (B, S, d_model)."""
    del rules
    if mesh is not None:
        raise NotImplementedError(
            "apply_moe on a mesh (the sharded and expert-parallel FFN) is "
            "not ported to repro_torch yet (ROADMAP Queue 1 item 13c)")
    y, aux = _local_moe(cfg, p, x)
    if cfg.num_shared_experts > 0:
        sp = p["shared"]
        a = act_fn(cfg.act)
        h = a(matmul(x, sp["wi_gate"])) * matmul(x, sp["wi_up"])
        y = y + matmul(h, sp["wo"]) * torch.sigmoid(matmul(x, sp["gate"]))
    return y, aux
