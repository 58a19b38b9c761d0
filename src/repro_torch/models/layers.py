"""Core layer library of the transformer stack: param specs, norms, MLP,
embeddings, RoPE.  Ported from the JAX package's ``repro/models/layers.py``.

Parameters are plain nested dicts (and lists) of tensors in the JAX
package's layout, so its parameters load unchanged
(``repro_torch.weights.from_jax_params``).  Every module exposes
  specs(cfg)  -> tree of Spec (shape + logical axes + init)
  apply(...)  -> forward
and ``init_tree`` turns a spec tree into parameters (``param_shapes`` into
shape-and-dtype stand-ins).  The logical axes shard the parameters over a
mesh (``repro_torch.parallel.sharding``, ``Model(mesh=, rules=)``).

Products of two dtypes (a bf16 activation with fp32 weights, or the
reverse) go through ``matmul`` and ``einsum``: ``jnp`` promotes their
operands to the common dtype, where torch's products raise.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import row_parallel, settle


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


def stack_specs(spec_tree, n: int, axis_name: str = "layer"):
    """Prepend a stacking dim of ``n`` (the ``"scanned"`` layout's layers).
    ``fan_in`` stays the unstacked leaf's, so ``init_tree`` draws each
    layer at its own scale."""
    return map_specs(
        lambda s: Spec((n,) + s.shape, (axis_name,) + s.axes, s.init,
                       s.fan_in or (s.shape[0] if s.shape else 1)),
        spec_tree)


# Truncated normal on [-2, 2] by inverting the normal CDF on a uniform draw:
# u ~ U(erf(-2/sqrt 2), erf(2/sqrt 2)), x = sqrt(2) erfinv(u).
_TRUNC = math.erf(2.0 / math.sqrt(2.0))


def _draw(generator, shape, std):
    """fp32 normal truncated to [-2, 2] times ``std``, written in place."""
    t = torch.empty(shape, device=generator.device)
    t.uniform_(-_TRUNC, _TRUNC, generator=generator)
    return t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(std)


def init_tree(generator: torch.Generator, spec_tree, dtype=torch.float32):
    """Parameters of ``dtype`` for ``spec_tree`` on ``generator``'s device:
    "normal" leaves are a normal truncated to [-2, 2] times
    ``1/sqrt(fan_in)``, drawn in fp32 leaf after leaf from ``generator``
    (written in place, so an fp32 leaf takes no temporaries: a full-width
    embedding is 4.2 GB), then rounded to ``dtype``, as the reference
    draws and rounds.  Below fp32 a stacked leaf (leading ``"layer"``
    axis) is drawn and rounded one layer at a time, so its fp32 copy never
    exists whole: InternVL2-26B's stacked MLP leaf would take 19.3 GB.
    The draws differ from ``jax.random``'s; carry JAX parameters across
    with ``repro_torch.weights.from_jax_params`` to compare the
    packages."""
    dev = generator.device

    def one(spec: Spec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=dev)
        fan_in = spec.fan_in or (spec.shape[0] if spec.shape else 1)
        std = 1.0 / math.sqrt(max(fan_in, 1))
        if dtype == torch.float32 or spec.axes[:1] != ("layer",):
            return _draw(generator, spec.shape, std).to(dtype)
        t = torch.empty(spec.shape, dtype=dtype, device=dev)
        for layer in t:
            layer.copy_(_draw(generator, spec.shape[1:], std))
        return t

    return map_specs(one, spec_tree)


def param_shapes(spec_tree, dtype=torch.float32):
    """Stand-ins for the parameters of ``spec_tree``: tensors of ``dtype``
    on the ``meta`` device (shape and dtype, no storage), the counterpart
    of the reference's ``shape_tree``."""
    return map_specs(lambda s: torch.empty(s.shape, dtype=dtype,
                                           device="meta"), spec_tree)


# --------------------------------------------------------------------------
# Products of mixed dtypes
# --------------------------------------------------------------------------

def promoted(*ts):
    """``ts`` cast to their common dtype (``torch.promote_types``); a
    tensor already of that dtype is returned as it is."""
    dt = functools.reduce(torch.promote_types, (t.dtype for t in ts))
    return [t.to(dt) for t in ts]


def matmul(a, b):
    """``a @ b`` in the promoted dtype of the two, as ``jnp`` computes it."""
    a, b = promoted(a, b)
    return a @ b


def einsum(eq: str, *operands):
    """``torch.einsum`` in the promoted dtype of the operands, as
    ``jnp.einsum`` computes it."""
    return torch.einsum(eq, *promoted(*operands))


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


def apply_mlp(cfg, p, x, constrain=None):
    a = act_fn(cfg.act)
    if "wi_gate" in p:
        h = a(matmul(x, p["wi_gate"])) * matmul(x, p["wi_up"])
    else:
        h = a(matmul(x, p["wi"]))
    if constrain is not None:
        h = constrain(h, ("batch", "seq", "mlp"))
    return settle(row_parallel(*promoted(h, p["wo"])))


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


def sinusoidal_positions(seq_len: int, d: int, device=None):
    """(seq_len, d) fp32 sinusoidal position table: sines in the even
    columns, cosines in the odd."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, dim / d)
    pe = torch.zeros((seq_len, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang[:, : (d + 1) // 2])
    return pe
