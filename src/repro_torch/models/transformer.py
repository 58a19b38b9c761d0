"""Composable transformer stack, ported from the JAX package's
``repro/models/transformer.py`` for the layer kinds ``attn`` (with an MLP,
or with the MoE FFN when the config has experts), ``local_attn``,
``rglru``, ``mlstm`` and ``slstm``: the training forward (``apply_stack``,
optionally rematerialised layer by layer, summing the MoE layers' aux
losses), prefill and decode, in both of its layouts:

* ``"layers"``  — heterogeneous stacks (RecurrentGemma, xLSTM): a list of
  per-layer parameter dicts and states, one python loop;
* ``"scanned"`` — homogeneous ``attn`` stacks (StableLM, ChatGLM3, Qwen3,
  Mistral-Large and the MoE models Qwen1.5-MoE and Mixtral): every
  parameter and state leaf stacked along a leading layer axis, as the
  reference stacks them for its ``lax.scan``; the port loops over the
  layers with views ``[l]`` of the stacked tensors.  The decode state is
  ``{"k", "v": (L, B, W, K, hd), "slot_pos": (L, W), "pos": (L,)}``.

The xLSTM blocks have ``ln1`` and a cell, no ``ln2`` and no MLP.  The
decode state's k, v and conv history take the state dtype (``dtype``:
bf16 under bf16 activations, else fp32); the recurrent carries stay fp32.

On a mesh (``Model(mesh=, rules=)``: DTensor parameters and
activations) the blocks take the mesh, the rules and ``constrain`` (the
reference's activation-sharding points: the block's residual output, the
MLP's hidden, the attention's queries); the MoE FFN runs its explicit
collectives (``moe.apply_moe``), and the recurrent cells (RG-LRU, mLSTM,
sLSTM) run on each rank's batch rows with their parameters gathered
(``_batch_local``).

The encoder-decoder stack (Whisper) is two ``"layers"`` lists:
``apply_encoder`` (bidirectional self attention, through
``flash_attention`` under ``impl="kernel"``) and ``apply_decoder`` (causal
self attention, then cross attention to the encoder's K/V), each layer
optionally rematerialised; its decode lives in ``models/model.py``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tracing
from repro_torch.models import attention as attn
from repro_torch.models import recurrent as rec
from repro_torch.models.layers import (apply_mlp, apply_norm, mlp_specs,
                                       norm_specs, sinusoidal_positions,
                                       stack_specs)
from repro_torch.models.moe import apply_moe, moe_specs
from repro_torch.parallel.sharding import fsdp_gather

_KINDS = ("attn", "local_attn", "rglru", "mlstm", "slstm")


def _check_kind(kind: str):
    if kind not in _KINDS:
        raise ValueError(kind)


def check_config(cfg):
    """Raise ``ValueError`` for a layer kind the stack does not know."""
    for kind in set(cfg.layer_kinds):
        _check_kind(kind)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked (``"scanned"``) tree: views, no copies."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _unbind(tree, n: int) -> list:
    """The ``n`` layers of a stacked (``"scanned"``) tree, each leaf
    unbound along its layer axis (``torch.unbind``)."""
    if isinstance(tree, dict):
        per = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _scan_carry(x_in, x_out):
    """``x_out``, checked to keep ``x_in``'s dtype: the reference's
    ``lax.scan`` over a ``"scanned"`` stack refuses a carry whose dtype
    changes (fp32 weights on a bf16 residual stream), so the port refuses
    it too."""
    if x_out.dtype != x_in.dtype:
        raise TypeError(f"the scanned stack's residual stream changes dtype "
                        f"in a layer ({x_in.dtype} -> {x_out.dtype}); the "
                        "reference's lax.scan refuses such a carry")
    return x_out


def _window(cfg, kind: str) -> int:
    return cfg.sliding_window if kind == "attn" else cfg.local_window


# --------------------------------------------------------------------------
# Per-layer specs
# --------------------------------------------------------------------------

def block_specs(cfg, kind: str):
    _check_kind(kind)
    s: Dict[str, Any] = {"ln1": norm_specs(cfg)}
    if kind in ("mlstm", "slstm"):
        s["cell"] = (rec.mlstm_specs if kind == "mlstm"
                     else rec.slstm_specs)(cfg)
        return s
    if kind in ("attn", "local_attn"):
        s["attn"] = attn.attention_specs(cfg)
    else:
        s["rnn"] = rec.rglru_specs(cfg)
    s["ln2"] = norm_specs(cfg)
    if cfg.is_moe and kind == "attn":
        s["moe"] = moe_specs(cfg)
    else:
        s["mlp"] = mlp_specs(cfg)
    return s


def enc_block_specs(cfg):
    return {
        "ln1": norm_specs(cfg),
        "attn": attn.attention_specs(cfg),
        "ln2": norm_specs(cfg),
        "mlp": mlp_specs(cfg),
    }


def dec_block_specs(cfg):
    """Decoder block with cross attention (enc-dec archs)."""
    return {
        "ln1": norm_specs(cfg),
        "attn": attn.attention_specs(cfg),
        "ln_x": norm_specs(cfg),
        "xattn": attn.cross_attention_specs(cfg),
        "ln2": norm_specs(cfg),
        "mlp": mlp_specs(cfg),
    }


def _ffn(cfg, p, x, mesh=None, rules=None, constrain=None):
    """The block's second half, on the normed input: the MoE FFN (its aux
    loss) or the MLP (a zero aux)."""
    if "moe" in p:
        return apply_moe(cfg, p["moe"], x, mesh=mesh, rules=rules)
    return (apply_mlp(cfg, p["mlp"], x, constrain=constrain),
            torch.zeros((), device=x.device))


def _batch_local(fn, x, p, *states):
    """``fn(x, p, *states)``; on a mesh (``x`` a DTensor) on each rank's
    batch rows of ``x`` and the states, with the parameters ``p`` whole
    (gathered).  Every output with a leading dim is laid out as ``x``'s
    batch, a 0-d one replicated.  Gradients as ``sharding.shard_map``'s."""
    from repro_torch.parallel import sharding as shd
    if not shd.is_dtensor(x):
        return fn(x, p, *states)
    from torch.distributed.tensor import Replicate
    from torch.utils._pytree import tree_map
    mesh = x.device_mesh
    bpl = shd.batch_placements(x)
    rpl = tuple(Replicate() for _ in bpl)

    def local(t, pl):
        return shd.to_local(t, pl) if shd.is_dtensor(t) else t

    out = fn(local(x, bpl), tree_map(lambda t: local(t, rpl), p),
             *(tree_map(lambda t: local(t, bpl), st) for st in states))
    return tree_map(lambda t: shd.from_local(t, mesh, bpl if t.ndim
                                             else rpl), out)


def _xlstm(cfg, kind, p, x, impl):
    """An xLSTM block's cell on its normed input: (h, final state); the
    mLSTM in its chunkwise-parallel form under ``impl="chunked"``."""
    if kind == "slstm":
        fn = rec.apply_slstm
    else:
        fn = rec.apply_mlstm_chunked if impl == "chunked" else rec.apply_mlstm
    return _batch_local(lambda x_, p_: fn(cfg, p_, x_),
                        apply_norm(cfg, p["ln1"], x), p["cell"])


def _rglru(cfg, p, x, impl, return_state=False):
    return _batch_local(lambda x_, p_: rec.apply_rglru(
        cfg, p_, x_, impl=impl, return_state=return_state), x, p)


def _residual(x, constrain):
    """The block's residual output at its sharding point: sequence
    parallel under ``SEQ_PARALLEL_RULES``, a no-op under the default
    rules and off a mesh."""
    if constrain is None:
        return x
    return constrain(x, ("batch", "act_seq", "act_embed"))


# --------------------------------------------------------------------------
# Per-layer forward (full sequence)
# --------------------------------------------------------------------------

def apply_block(cfg, kind, p, x, *, impl="kernel", mesh=None, rules=None,
                constrain=None):
    """Full-sequence block.  Returns (x, aux): aux the MoE layer's
    load-balance and z loss, else a zero."""
    _check_kind(kind)
    p = fsdp_gather(p)
    if kind in ("mlstm", "slstm"):
        x = x + _xlstm(cfg, kind, p, x, impl)[0]
        return _residual(x, constrain), torch.zeros((), device=x.device)
    if kind in ("attn", "local_attn"):
        x = x + attn.self_attention(cfg, p["attn"],
                                    apply_norm(cfg, p["ln1"], x), causal=True,
                                    window=_window(cfg, kind), impl=impl,
                                    constrain=constrain)
    else:
        x = x + _rglru(cfg, p["rnn"], apply_norm(cfg, p["ln1"], x), impl)
    h, aux = _ffn(cfg, p, apply_norm(cfg, p["ln2"], x), mesh, rules,
                  constrain)
    return _residual(x + h, constrain), aux


# --------------------------------------------------------------------------
# Per-layer decode (one token, stateful)
# --------------------------------------------------------------------------

def init_layer_state(cfg, kind, batch: int, max_len: int, device=None,
                     dtype=torch.float32):
    """An empty decode state of one layer; k, v and the conv history of
    ``dtype``, the recurrent carries fp32."""
    _check_kind(kind)
    if kind in ("attn", "local_attn"):
        window = _window(cfg, kind)
        W = min(window, max_len) if window > 0 else max_len
        return attn.init_kv_cache(cfg, batch, W, device=device, dtype=dtype)
    if kind == "mlstm":
        return rec.mlstm_init_state(cfg, batch, device=device)
    if kind == "slstm":
        return rec.slstm_init_state(cfg, batch, device=device)
    return rec.rglru_init_state(cfg, batch, device=device, dtype=dtype)


def prefill_block(cfg, kind, p, x, *, cache_len, impl="kernel",
                  dtype=torch.float32, mesh=None, rules=None, constrain=None):
    """Full-sequence block that also returns the decode state (prefill),
    its k, v and conv history of ``dtype``.  The MoE layer's aux loss is
    dropped, as the reference drops it."""
    _check_kind(kind)
    p = fsdp_gather(p)
    if kind in ("mlstm", "slstm"):
        h, st = _xlstm(cfg, kind, p, x, impl)
        return x + h, st
    if kind in ("attn", "local_attn"):
        with tracing.span("attn"):
            h, st = attn.self_attention_prefill(
                cfg, p["attn"], apply_norm(cfg, p["ln1"], x), causal=True,
                window=_window(cfg, kind), impl=impl, cache_len=cache_len,
                dtype=dtype, constrain=constrain)
    else:
        h, st = _rglru(cfg, p["rnn"], apply_norm(cfg, p["ln1"], x), impl,
                       return_state=True)
        st["conv"] = st["conv"].to(dtype)
    x = x + h
    return x + _ffn(cfg, p, apply_norm(cfg, p["ln2"], x), mesh, rules,
                    constrain)[0], st


def apply_stack(cfg, p, x, *, impl="kernel", remat=False, mesh=None,
                rules=None, constrain=None):
    """Full-sequence stack (the training forward).  Returns (x, aux); aux
    is the sum of the MoE layers' load-balance and z losses (0 without
    experts).

    Both layouts loop over the layers in python, the ``"scanned"`` one over
    its stacked leaves unbound along the layer axis (``_unbind``: under
    autograd each leaf's gradient is then one stack of the layers'
    gradients; views ``[l]`` would each add a zero-filled gradient of the
    whole stacked leaf).  ``remat=True`` runs each layer under
    ``torch.utils.checkpoint`` (non-reentrant), the reference's
    ``jax.checkpoint`` per layer: the backward recomputes the layer's
    activations instead of keeping them.  It changes memory, not the
    numbers; ``torch.func`` transforms do not take it."""
    if cfg.homogeneous:
        layers = [("attn", lp) for lp in _unbind(p["scanned"],
                                                  cfg.num_layers)]
    else:
        layers = list(zip(cfg.layer_kinds, p["layers"]))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, lp in layers:
        fn = functools.partial(apply_block, cfg, kind, impl=impl, mesh=mesh,
                               rules=rules, constrain=constrain)
        x_in = x
        x, a = _run(fn, remat, lp, x)
        if cfg.homogeneous:
            _scan_carry(x_in, x)
        aux = aux + a
    return x, aux


def prefill_stack(cfg, p, x, *, cache_len, impl="kernel",
                  dtype=torch.float32, mesh=None, rules=None, constrain=None):
    """Full-sequence stack returning (x, decode_state) — the prefill path;
    the state's k, v and conv history of ``dtype``."""
    states = []
    kw = dict(cache_len=cache_len, impl=impl, dtype=dtype, mesh=mesh,
              rules=rules, constrain=constrain)
    if cfg.homogeneous:
        for i in range(cfg.num_layers):
            h, st = prefill_block(cfg, "attn", _layer(p["scanned"], i), x,
                                  **kw)
            x = _scan_carry(x, h)
            states.append(st)
        return x, {"scanned": {k: torch.stack([st[k] for st in states])
                               for k in states[0]}}
    for kind, lp in zip(cfg.layer_kinds, p["layers"]):
        x, st = prefill_block(cfg, kind, lp, x, **kw)
        states.append(st)
    return x, {"layers": states}


def decode_block(cfg, kind, p, x, state, *, impl="kernel", in_place=False,
                 mesh=None, rules=None):
    """One-token block.  Returns (x, new_state); ``in_place`` writes an
    attention layer's token into ``state`` itself (see
    ``attention.decode_self_attention``).  The reference decodes the MoE
    with ``mesh=None``, its capacity from the whole batch; on a mesh the
    port keeps the experts sharded by the rules and gathers the batch
    (``apply_moe(shard_batch=False)``), the same function."""
    _check_kind(kind)
    p = fsdp_gather(p)
    if kind in ("mlstm", "slstm"):
        step = (rec.mlstm_decode_step if kind == "mlstm"
                else rec.slstm_decode_step)
        h, state = _batch_local(lambda x_, p_, s_: step(cfg, p_, x_, s_),
                                apply_norm(cfg, p["ln1"], x), p["cell"],
                                state)
        return x + h, state
    if kind in ("attn", "local_attn"):
        with tracing.span("attn"):
            h, state = attn.decode_self_attention(
                cfg, p["attn"], apply_norm(cfg, p["ln1"], x), state,
                window=_window(cfg, kind), impl=impl, in_place=in_place)
    else:
        h, state = _batch_local(
            lambda x_, p_, s_: rec.rglru_decode_step(cfg, p_, x_, s_),
            apply_norm(cfg, p["ln1"], x), p["rnn"], state)
    x = x + h
    h2in = apply_norm(cfg, p["ln2"], x)
    if "moe" in p:
        return x + apply_moe(cfg, p["moe"], h2in, mesh=mesh, rules=rules,
                             shard_batch=False)[0], state
    return x + apply_mlp(cfg, p["mlp"], h2in), state


# --------------------------------------------------------------------------
# Stack
# --------------------------------------------------------------------------

def stack_specs_tree(cfg):
    if cfg.homogeneous:
        return {"scanned": stack_specs(block_specs(cfg, "attn"),
                                       cfg.num_layers)}
    return {"layers": [block_specs(cfg, k) for k in cfg.layer_kinds]}


def layer_state_axes(cfg, kind):
    """The logical axes of one layer's decode state."""
    _check_kind(kind)
    if kind in ("attn", "local_attn"):
        return {"k": ("batch", "seq", "kv_heads", "head_dim"),
                "v": ("batch", "seq", "kv_heads", "head_dim"),
                "slot_pos": ("seq",), "pos": None}
    if kind == "rglru":
        return rec.rglru_state_axes()
    if kind == "mlstm":
        return rec.mlstm_state_axes()
    return rec.slstm_state_axes()


def stack_state_axes(cfg):
    """The logical axes of the stack's decode state: the scanned layout's
    leaves gain a leading ``"layer"`` axis (``pos`` becomes ("layer",))."""
    if cfg.homogeneous:
        return {"scanned": {
            k: ("layer",) + a if isinstance(a, tuple) else ("layer",)
            for k, a in layer_state_axes(cfg, "attn").items()}}
    return {"layers": [layer_state_axes(cfg, k) for k in cfg.layer_kinds]}


def init_stack_state(cfg, batch: int, max_len: int, device=None,
                     dtype=torch.float32):
    if cfg.homogeneous:
        one = init_layer_state(cfg, "attn", batch, max_len, device, dtype)
        return {"scanned": {k: torch.stack([v] * cfg.num_layers)
                            for k, v in one.items()}}
    return {"layers": [init_layer_state(cfg, k, batch, max_len, device,
                                        dtype) for k in cfg.layer_kinds]}


def decode_stack(cfg, p, x, state, *, impl="kernel", mesh=None, rules=None):
    """One-token decode through the stack.  Returns (x, new_state); the old
    state is left as it was.  The scanned layout copies its stacked k, v
    and slot_pos once per step and writes each layer's token into that
    copy (ROADMAP Queue 4: in place)."""
    if cfg.homogeneous and _on_mesh(x):
        # out of place on a mesh: each layer's new state, stacked
        old, states = state["scanned"], []
        for i in range(cfg.num_layers):
            h, st = decode_block(cfg, "attn", _layer(p["scanned"], i), x,
                                 _layer(old, i), impl=impl, mesh=mesh,
                                 rules=rules)
            x = _scan_carry(x, h)
            states.append(st)
        return x, {"scanned": {k: torch.stack([st[k] for st in states])
                               for k in states[0]}}
    if cfg.homogeneous:
        old = state["scanned"]
        with tracing.span("decode.cache_copy"):
            new = {k: old[k].clone() for k in ("k", "v", "slot_pos")}
        for i in range(cfg.num_layers):
            ls = {k: t[i] for k, t in new.items()}
            ls["pos"] = old["pos"][i]
            h, _ = decode_block(cfg, "attn", _layer(p["scanned"], i), x, ls,
                                impl=impl, in_place=True)
            x = _scan_carry(x, h)
        new["pos"] = old["pos"] + 1
        return x, {"scanned": new}
    new_states = []
    for kind, lp, ls in zip(cfg.layer_kinds, p["layers"], state["layers"]):
        x, ns = decode_block(cfg, kind, lp, x, ls, impl=impl, mesh=mesh,
                             rules=rules)
        new_states.append(ns)
    return x, {"layers": new_states}


# --------------------------------------------------------------------------
# Encoder-decoder (whisper-style)
# --------------------------------------------------------------------------

def encdec_specs_tree(cfg):
    return {
        "encoder": [enc_block_specs(cfg)
                    for _ in range(cfg.num_encoder_layers)],
        "enc_norm": norm_specs(cfg),
        "decoder": [dec_block_specs(cfg) for _ in range(cfg.num_layers)],
    }


def _enc_block(cfg, impl, constrain, lp, h):
    lp = fsdp_gather(lp)
    h = h + attn.self_attention(cfg, lp["attn"], apply_norm(cfg, lp["ln1"], h),
                                causal=False, impl=impl, constrain=constrain)
    return h + apply_mlp(cfg, lp["mlp"], apply_norm(cfg, lp["ln2"], h),
                         constrain=constrain)


def _dec_block(cfg, impl, constrain, lp, h, enc_out):
    lp = fsdp_gather(lp)
    h = h + attn.self_attention(cfg, lp["attn"], apply_norm(cfg, lp["ln1"], h),
                                causal=True, impl=impl, constrain=constrain)
    kx, vx = attn.encode_kv(cfg, lp["xattn"], enc_out)
    h = h + attn.cross_attention(cfg, lp["xattn"],
                                 apply_norm(cfg, lp["ln_x"], h), kx, vx,
                                 impl=impl)
    return h + apply_mlp(cfg, lp["mlp"], apply_norm(cfg, lp["ln2"], h),
                         constrain=constrain)


def _on_mesh(x) -> bool:
    from repro_torch.parallel.sharding import is_dtensor
    return is_dtensor(x)


def _run(fn, remat, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``remat``."""
    return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)


def apply_encoder(cfg, p, frames, *, impl="kernel", remat=True,
                  constrain=None):
    """The encoder over frame embeddings (B, S, D) plus sinusoidal
    positions: bidirectional self attention and an MLP a layer, then the
    encoder's final norm."""
    x = frames + sinusoidal_positions(frames.shape[1], cfg.d_model,
                                      frames.device).to(frames.dtype)
    for lp in p["encoder"]:
        x = _run(functools.partial(_enc_block, cfg, impl, constrain), remat,
                 lp, x)
    return apply_norm(cfg, p["enc_norm"], x)


def apply_decoder(cfg, p, x, enc_out, *, impl="kernel", remat=True,
                  constrain=None):
    """The decoder over token embeddings (B, St, D) with positions added:
    causal self attention, cross attention to ``enc_out`` (each layer's
    K/V projected from it) and an MLP a layer."""
    for lp in p["decoder"]:
        x = _run(functools.partial(_dec_block, cfg, impl, constrain), remat,
                 lp, x, enc_out)
    return x
