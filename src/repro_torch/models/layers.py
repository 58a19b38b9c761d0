"""Core layer library of the transformer stack: param specs, norms, MLP,
embeddings, RoPE.  Ported from the JAX package's ``repro/models/layers.py``.

Parameters are plain nested dicts (and lists) of tensors in the JAX
package's layout, so its parameters load unchanged
(``repro_torch.weights.from_jax_params``).  Every module exposes
  specs(cfg)  -> tree of Spec (shape + logical axes + init)
  apply(...)  -> forward
and ``init_tree`` turns a spec tree into parameters.  The logical axes are
kept for the layout's sake; the port runs on one card and shards nothing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones
    fan_in: Optional[int] = None  # None -> shape[0]

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def map_specs(fn, tree):
    """``fn`` applied to every Spec of a tree of dicts and lists."""
    if isinstance(tree, Spec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_specs(fn, v) for v in tree]
    raise TypeError(f"not a spec tree: {type(tree)}")


def spec_leaves(tree):
    out = []
    map_specs(out.append, tree)
    return out


# Truncated normal on [-2, 2] by inverting the normal CDF on a uniform draw:
# u ~ U(erf(-2/sqrt 2), erf(2/sqrt 2)), x = sqrt(2) erfinv(u).
_TRUNC = math.erf(2.0 / math.sqrt(2.0))


def init_tree(generator: torch.Generator, spec_tree):
    """fp32 parameters for ``spec_tree`` on ``generator``'s device: "normal"
    leaves are a normal truncated to [-2, 2] times ``1/sqrt(fan_in)``,
    drawn leaf after leaf from ``generator`` (written in place, so a leaf
    takes no temporaries: a full-width embedding is 4.2 GB).  The draws
    differ from ``jax.random``'s; carry JAX parameters across with
    ``repro_torch.weights.from_jax_params`` to compare the packages."""
    dev = generator.device

    def one(spec: Spec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, device=dev)
        fan_in = spec.fan_in or (spec.shape[0] if spec.shape else 1)
        std = 1.0 / math.sqrt(max(fan_in, 1))
        t = torch.empty(spec.shape, device=dev)
        t.uniform_(-_TRUNC, _TRUNC, generator=generator)
        return t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(std)

    return map_specs(one, spec_tree)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def norm_specs(cfg, d: Optional[int] = None):
    d = d or cfg.d_model
    if cfg.norm_type == "layernorm":
        return {"scale": Spec((d,), ("act_embed",), "ones"),
                "bias": Spec((d,), ("act_embed",), "zeros")}
    return {"scale": Spec((d,), ("act_embed",), "ones")}


def apply_norm(cfg, p, x):
    dt = x.dtype
    x = x.float()
    if cfg.norm_type == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = x.square().mean(-1, keepdim=True)
        y = x * torch.rsqrt(ms + cfg.norm_eps) * p["scale"].float()
    return y.to(dt)


def rms_norm(x, scale, eps=1e-6):
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(dt)


# --------------------------------------------------------------------------
# Activations / MLP
# --------------------------------------------------------------------------

def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation; torch's to erf.
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu, "relu": F.relu}[name]


def mlp_specs(cfg, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "silu":  # SwiGLU: gate + up + down
        return {
            "wi_gate": Spec((d, f), ("embed", "mlp")),
            "wi_up": Spec((d, f), ("embed", "mlp")),
            "wo": Spec((f, d), ("mlp", "embed")),
        }
    return {
        "wi": Spec((d, f), ("embed", "mlp")),
        "wo": Spec((f, d), ("mlp", "embed")),
    }


def apply_mlp(cfg, p, x):
    a = act_fn(cfg.act)
    if "wi_gate" in p:
        h = a(x @ p["wi_gate"]) * (x @ p["wi_up"])
    else:
        h = a(x @ p["wi"])
    return h @ p["wo"]


# --------------------------------------------------------------------------
# Embeddings / unembedding
# --------------------------------------------------------------------------

def embed_specs(cfg):
    s = {"embedding": Spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                           fan_in=cfg.d_model)}
    if not cfg.tie_embeddings:
        s["lm_head"] = Spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return s


def embed_tokens(p, tokens):
    return p["embedding"][tokens]


def unembed_matrix(cfg, p):
    return p["embedding"].T if cfg.tie_embeddings else p["lm_head"]


# --------------------------------------------------------------------------
# Rotary position embeddings (full / partial fraction / none)
# --------------------------------------------------------------------------

def rope_freqs(cfg, head_dim: int, device=None):
    rot = int(head_dim * cfg.rope_fraction)
    rot -= rot % 2
    if rot == 0:
        return None
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (cfg.rope_theta ** exps)   # (rot/2,)


def apply_rope(x, positions, inv_freqs):
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    if inv_freqs is None:
        return x
    rot = inv_freqs.shape[0] * 2
    xr, xp = x[..., :rot], x[..., rot:]
    ang = positions[..., :, None].float() * inv_freqs   # (..., S, rot/2)
    sin, cos = ang.sin()[..., None, :], ang.cos()[..., None, :]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)
