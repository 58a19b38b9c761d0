"""Mixture-of-Experts FFN: top-k routing, capacity dispatch, shared experts.
Ported from the JAX package's ``repro/models/moe.py``, on one device
(``apply_moe(mesh=None)``) and on a mesh.

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

On a mesh (DTensor activations and parameters) the routed experts run
under ``sharding.shard_map`` (``local_map``), the reference's
``shard_map``, with its explicit collectives (``sharding.psum``,
``all_gather``, ``all_to_all``: functional collectives, so a cost walk sees
them as ops).  Both bodies are ``_local_moe`` with an expert step of its
own:

* the default, tensor-parallel one (``_expert_ffn``): every data shard
  routes its OWN tokens, so the capacity ``C`` comes from the local ``T``
  (a run with data > 1 drops other picks than one device when a bin
  overflows, as the reference's mesh run does); the FSDP-sharded expert
  weights are all-gathered over 'data', the expert products run on the
  rank's 'model' slice of the experts' hidden dim, and their output is
  summed over 'model' in the activation dtype.  The decode step's call
  (``shard_batch=False``: every shard holds the whole batch) keeps the
  weights sharded instead, as GSPMD partitions the reference's
  ``apply_moe(mesh=None)``: the router and the gate and up products
  contract each rank's slice of D with its own rows and sum the
  partials over the FSDP axis in fp32 (``_split_contract``), and the
  down product writes the rank's own D columns, summed over 'model',
  then gathered over the FSDP axis;
* the expert-parallel one (``_expert_parallel_ffn``, under
  ``EXPERT_PARALLEL_RULES``): the experts shard over 'model' and the
  capacity bins travel to their expert's rank and back by two
  ``all_to_all``s.

Either way the aux loss is averaged over the data axes.  The shared
experts run on DTensors outside the ``shard_map``, their second product
through ``sharding.row_parallel`` as the MLP's.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch import tracing
from repro_torch.launch.mesh import DATA_AXIS, MODEL_AXIS, POD_AXIS
from repro_torch.models.layers import Spec, act_fn, matmul, promoted
from repro_torch.parallel import sharding as shd

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


def _my_slice(t, split, dim: int):
    """``t``'s slice along ``dim`` that this rank holds when ``dim`` is
    split evenly over mesh axis ``split = (mesh, axis)``."""
    mesh, axis = split
    n = mesh.size(tuple(mesh.mesh_dim_names).index(axis))
    d = -(-t.shape[dim] // n)          # DTensor's Shard: torch.chunk's
    start = min(mesh.get_local_rank(axis) * d, t.shape[dim])
    return t.narrow(dim, start, min(d, t.shape[dim] - start))


def _split_contract(a, w_loc, split):
    """``a @ w`` with D (``a``'s last dim, ``w``'s rows) split over mesh
    axis ``split = (mesh, axis)``: this rank's slice of ``a`` against its
    own rows ``w_loc``, the partials summed over the axis in fp32 and the
    sum cast to the promoted dtype, where the unsplit product rounds."""
    mesh, axis = split
    part = matmul(_my_slice(a, split, -1).float(), w_loc)
    return shd.psum(part, mesh, axis).to(
        torch.promote_types(a.dtype, w_loc.dtype))


def router_probs(router_w, xt, split=None):
    """The router's float32 logits and softmax probabilities, (T, E);
    with ``split`` (``_split_contract``), D's contraction split over a
    mesh axis."""
    logits = matmul(xt, router_w) if split is None else \
        _split_contract(xt, _my_slice(router_w, split, 0), split)
    logits = logits.to(torch.float32)
    return logits, torch.softmax(logits, -1)


def _route(cfg, router_w, xt, split=None):
    """xt: (T, D) -> gates (T,k), experts (T,k), aux losses."""
    logits, probs = router_probs(router_w, xt, split)
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


def _expert_ffn(cfg, p, buf, E: int, C: int, mesh=None, axis=None,
                gather_axis=None, split_axis=None):
    """buf (E*C+1, D) -> (E*C+1, D), the overflow row's output zeros.  On a
    mesh: the FSDP-sharded weights all-gathered over ``gather_axis`` or,
    with ``split_axis`` instead, kept sharded (the gate and up products
    through ``_split_contract``, the down product's D columns gathered
    over the axis at the end); the output summed over ``axis`` (tensor
    parallel) in the activation dtype."""
    a = act_fn(cfg.act)
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    if gather_axis is not None:  # FSDP all-gather of the embed dim
        wg = shd.all_gather(wg, mesh, gather_axis, 1)
        wu = shd.all_gather(wu, mesh, gather_axis, 1)
        wd = shd.all_gather(wd, mesh, gather_axis, 2)
    eb = buf[: E * C].reshape(E, C, -1)
    if split_axis is None:
        h = a(matmul(eb, wg)) * matmul(eb, wu)
    else:
        split = (mesh, split_axis)
        h = a(_split_contract(eb, wg, split)) * _split_contract(eb, wu, split)
    out = matmul(h, wd)
    if axis is not None:
        # reduce in the activation dtype, as the reference does
        out = shd.psum(out.to(buf.dtype), mesh, axis)    # TP reduce
    if split_axis is not None:
        out = shd.all_gather(out.to(buf.dtype), mesh, split_axis, 2)
    out = out.reshape(E * C, -1)
    return torch.cat([out, torch.zeros_like(out[:1])], 0)


def _combine(out_buf, dst, top_p, T: int, k: int):
    y = out_buf[dst]                                       # (T*k, D); overflow->0
    y = y * top_p.reshape(-1)[:, None].to(y.dtype)
    return y.reshape(T, k, -1).sum(1)


def _local_moe(cfg, p, x, expert_step, mesh=None, data_axes=(),
               split_axis=None):
    """The routed experts of one device or one shard.  x: (B, S, D) with
    full D; the capacity from these tokens.  ``expert_step(p, buf, E, C)``
    maps the capacity bins (E*C+1, D) to their outputs: ``_expert_ffn``
    (on a mesh, tensor parallel) or ``_expert_parallel_ffn``.  The aux
    loss is averaged over ``data_axes``.  ``split_axis``: the router's
    contraction split over that mesh axis (``_split_contract``)."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    C = _capacity(T, E, k, cfg.capacity_factor)
    # (unsplit, ``_route`` keeps the three-argument call that tests and
    # chip_smoke.py wrap to pin routes)
    with tracing.span("moe.route"):
        top_p, top_e, aux, z = (
            _route(cfg, p["router"], xt) if split_axis is None
            else _route(cfg, p["router"], xt, (mesh, split_axis)))
    with tracing.span("moe.dispatch"):
        buf, dst, keep = _dispatch(xt, top_e, k, E, C)
    # the capacity rows the products compute against the picks they keep
    tracing.count("moe.rows_computed", E * C)
    tracing.count("moe.picks", T * k)
    tracing.count_true("moe.picks_kept", keep)
    with tracing.span("moe.experts"):
        out_buf = expert_step(p, buf, E, C)
    with tracing.span("moe.combine"):
        y = _combine(out_buf, dst, top_p, T, k)
    aux_total = cfg.router_aux_loss * aux + 1e-3 * z
    if data_axes:
        n = 1
        for ax in data_axes:
            aux_total = shd.psum(aux_total, mesh, ax)
            n *= mesh.size(mesh.mesh_dim_names.index(ax))
        aux_total = aux_total / n
    return y.reshape(B, S, D), aux_total


def _expert_parallel_ffn(cfg, mesh, p, buf, E: int, C: int):
    """The expert-parallel expert step: the experts sharded over 'model',
    the capacity bins sent to their expert's rank and back by
    all_to_all."""
    D = buf.shape[-1]
    n_ep = mesh.size(mesh.mesh_dim_names.index(MODEL_AXIS))
    E_loc = E // n_ep
    # block i of `send` holds the bins of the experts rank i owns; block i
    # of `recv` came from rank i
    send = buf[: E * C].reshape(n_ep, E_loc * C, D)
    recv = shd.all_to_all(send, mesh, MODEL_AXIS)
    eb = recv.reshape(n_ep, E_loc, C, D).transpose(0, 1).reshape(
        E_loc, n_ep * C, D)
    a = act_fn(cfg.act)
    h = a(matmul(eb, p["w_gate"])) * matmul(eb, p["w_up"])
    out = matmul(h, p["w_down"])                    # (E_loc, n_ep*C, D)
    out = out.reshape(E_loc, n_ep, C, D).transpose(0, 1).reshape(
        n_ep, E_loc * C, D)
    back = shd.all_to_all(out, mesh, MODEL_AXIS)
    out_buf = back.reshape(E * C, D)
    return torch.cat([out_buf, torch.zeros_like(out_buf[:1])], 0)


def _shard_body(cfg, mesh, data_axes, split_axis, expert_step, x, router,
                w_gate, w_up, w_down):
    """The ``shard_map`` body: ``_local_moe`` on this shard's weights."""
    p = {"router": router, "w_gate": w_gate, "w_up": w_up, "w_down": w_down}
    return _local_moe(cfg, p, x, expert_step, mesh, data_axes, split_axis)


def _mesh_moe(cfg, p, x, mesh, rules, shard_batch: bool):
    """The routed experts on a mesh, under ``shard_map``: the default
    tensor-parallel body or, under rules with ``expert`` on 'model', the
    expert-parallel one.  ``shard_batch=False`` gathers the batch first
    (every shard routes all tokens: the capacity of the whole batch), and
    the tensor-parallel body then splits the router and expert
    contractions over the FSDP axis instead of gathering the weights."""
    names = tuple(mesh.mesh_dim_names)
    size = dict(zip(names, mesh.shape))
    dp = tuple(a for a in (POD_AXIS, DATA_AXIS) if a in names)
    model_in_mesh = MODEL_AXIS in names and size[MODEL_AXIS] > 1
    P = shd.P
    batch = (dp if len(dp) > 1 else (dp[0] if dp else None)) \
        if shard_batch else None
    data_axes = dp if shard_batch else ()
    split = None
    if rules.get("expert") == MODEL_AXIS:
        w_spec = P(MODEL_AXIS, None, None)
        specs = (w_spec, w_spec, w_spec)
        step = functools.partial(_expert_parallel_ffn, cfg, mesh)
    else:
        fsdp = rules.get("embed")
        fsdp = fsdp if (fsdp in names and size[fsdp] > 1) else None
        tp = MODEL_AXIS if model_in_mesh else None
        specs = (P(None, fsdp, tp), P(None, fsdp, tp), P(None, tp, fsdp))
        split = None if shard_batch else fsdp
        step = functools.partial(_expert_ffn, cfg, mesh=mesh, axis=tp,
                                 gather_axis=None if split else fsdp,
                                 split_axis=split)
    body = functools.partial(_shard_body, cfg, mesh, data_axes, split, step)
    pl = functools.partial(shd.placements_for, mesh)
    x_pl = pl(P(batch, None, None))
    ins = (x_pl, pl(P())) + tuple(pl(sp) for sp in specs)
    return shd.shard_map(body, mesh, ins, (x_pl, pl(P())))(
        x, p["router"], p["w_gate"], p["w_up"], p["w_down"])


def apply_moe(cfg, p, x, mesh=None, rules=None, shard_batch: bool = True):
    """MoE FFN.  Returns (y, aux_loss).  x: (B, S, d_model), a DTensor on
    ``mesh`` (see the module's docstring); ``shard_batch=False`` (the
    decode step's) routes the whole batch on every shard."""
    with tracing.span("moe"):
        if mesh is None:
            y, aux = _local_moe(cfg, p, x,
                                functools.partial(_expert_ffn, cfg))
        else:
            y, aux = _mesh_moe(cfg, p, x, mesh, rules or shd.DEFAULT_RULES,
                               shard_batch)
        if cfg.num_shared_experts > 0:
            with tracing.span("moe.shared"):
                sp = p["shared"]
                a = act_fn(cfg.act)
                h = a(matmul(x, sp["wi_gate"])) * matmul(x, sp["wi_up"])
                shared = shd.row_parallel(*promoted(h, sp["wo"]))
                y = y + shared * torch.sigmoid(matmul(x, sp["gate"]))
        return shd.settle(y), aux
