"""Public model API of the transformer stack: ``build_model(cfg) -> Model``.
Ported from the JAX package's ``repro/models/model.py``: ``param_specs``,
``init``, ``axes``, ``param_shapes``, ``num_params``, the training loss
(``loss``, through
``chunked_cross_entropy``), ``prefill``, ``init_decode_state``,
``decode_step`` and the ``input_specs``/``input_axes`` of a batch.

``impl`` picks the attention and RG-LRU scan route:
* ``"kernel"`` (the default; the JAX package's ``impl="pallas"``) runs
  prefill attention, decode attention and the RG-LRU scan through
  ``repro_torch.kernels``: the CUDA kernels on the card, their plain
  versions on the CPU.  The kernels have no backward, so on the card they
  refuse inputs that require grad: train through ``"xla_flash"``;
* ``"xla_flash"`` (the reference's default, its training route) runs
  blocked online-softmax attention and the plain scan in PyTorch,
  differentiable by autograd and ``torch.func``;
* ``"naive"`` runs dense attention, the reference decode's own attention
  formula and the plain scan: the oracle;
* ``"chunked"`` (the reference's two-level scans) runs attention as
  ``"xla_flash"`` does, the RG-LRU through ``rglru_scan_chunked`` and the
  mLSTM in its chunkwise-parallel form (``apply_mlstm_chunked``).
Homogeneous dense stacks keep the reference's ``"scanned"`` layout
(stacked parameters and decode state; ``models/transformer.py``).
``param_dtype`` and ``act_dtype`` (torch dtypes, fp32 by default, as the
reference's) set the parameters' dtype and the activations' (the
embedding, the frames and patches, and the unembedding are cast to
``act_dtype``); a product of two dtypes computes in the promoted one, as
``jnp`` does, so every output has the reference's dtype.  The decode
state's k, v and conv history are bf16 under bf16 activations, else fp32.
Prefill sizes the caches of global-attention layers for ``decode_margin``
more slots (0: one more prompt length, the reference's default).

``mesh`` (a ``torch.distributed`` ``DeviceMesh`` with the reference's
axis names, ``launch.mesh.make_host_mesh``) and ``rules`` (a rule set of
``repro_torch.parallel.sharding``) shard the model as the reference's
``Model(mesh=, rules=)`` does: the parameters and the batch are DTensors
(``sharding.distribute_tree``, or the ``*_shardings`` of
``launch/steps.py``), every op runs on them, and the blocks constrain
their activations at the reference's points (``_constrain``); the MoE and
attention run their local parts under ``shard_map``.  The outputs are
DTensors (``sharding.full`` gathers one).  With ``mesh=None`` nothing
changes.
``remat=True`` (the reference's default) recomputes each layer's
activations in the backward (``torch.utils.checkpoint``).

The frontends are stubs, as in the reference: an ``"audio"`` model
(Whisper, encoder-decoder) takes frame embeddings, a ``"vision"`` model
(InternVL2) patch embeddings that go before its tokens.  An
encoder-decoder prefill runs the encoder, projects each decoder layer's
cross-attention K/V and decodes the prompt's first token; its decoder's
self-attention ring has ``frames // decoder_len_ratio`` slots.

Batch layouts (see ``input_specs``):
  train   {'tokens', 'targets': (B, S) int}
          (+ 'patches' (B, P, D) for vision, 'frames' (B, S, D) for audio,
          whose tokens and targets are (B, S // decoder_len_ratio))
  prefill {'tokens'} (+ 'patches' or 'frames')
  decode  {'tokens': (B, 1)} with a separate decode-state tree
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models import attention as attn_mod
from repro_torch.parallel import sharding as shd
from repro_torch.models.layers import (
    apply_mlp, apply_norm, embed_specs, embed_tokens, init_tree, map_specs,
    matmul, norm_specs, param_shapes, sinusoidal_positions, spec_leaves,
    unembed_matrix,
)

IMPLS = ("kernel", "xla_flash", "naive", "chunked")


def chunked_cross_entropy(hidden, w_unembed, targets, mask=None, chunk=512):
    """Next-token cross entropy over sequence chunks of ``chunk``: the
    logits of one chunk, ``(B, chunk, V)``, at a time, never ``(B, S, V)``.

    hidden: (B,S,D); w_unembed: (D,V); targets: (B,S) int; mask: (B,S)
    weights or None.  Returns (sum_loss, sum_count), 0-d float32.  A
    sequence that is not a multiple of the chunk is padded with zero
    hidden rows, targets and mask, as the reference pads it.  Nothing is
    written in place, so ``torch.func`` transforms go through."""
    B, S, D = hidden.shape
    chunk = min(chunk, S)
    n = (S + chunk - 1) // chunk
    pad = n * chunk - S
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    loss = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, n * chunk, chunk):
        h, t, m = (hidden[:, i:i + chunk], targets[:, i:i + chunk],
                   mask[:, i:i + chunk].to(torch.float32))
        # on a mesh the vocab dim gathered (DTensor's vocab-parallel gather
        # is not taken)
        logits = shd.unshard(matmul(h, w_unembed).to(torch.float32), -1)
        lse = torch.logsumexp(logits, -1)
        ll = torch.gather(logits, -1, t.long()[..., None])[..., 0]
        loss = loss + torch.sum((lse - ll) * m)
        count = count + torch.sum(m)
    return loss, count


class Model:
    def __init__(self, cfg: ModelConfig, *, mesh=None, rules=None,
                 impl: str = "kernel", param_dtype=torch.float32,
                 act_dtype=torch.float32, remat: bool = True,
                 decode_margin: int = 0, device=None):
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        tfm.check_config(cfg)
        self.cfg = cfg
        self.mesh = mesh
        self.rules = rules
        self.impl = impl
        self.param_dtype = param_dtype
        self.act_dtype = act_dtype
        self.remat = remat
        # extra KV-cache slots reserved past the prompt by prefill()
        # (0 -> reserve one prompt-length's worth)
        self.decode_margin = decode_margin
        # on a mesh, the ranks' device type (a fake process group's mesh
        # may name the card where there is none)
        self.device = (torch.device(mesh.device_type) if mesh is not None
                       and device is None else resolve_device(device))

    # -- params ------------------------------------------------------------

    def param_specs(self):
        s: Dict[str, Any] = dict(embed_specs(self.cfg))
        s["final_norm"] = norm_specs(self.cfg)
        if self.cfg.encoder_decoder:
            s.update(tfm.encdec_specs_tree(self.cfg))
        else:
            s.update(tfm.stack_specs_tree(self.cfg))
        return s

    def init(self, rng):
        """Parameters of ``param_dtype`` on the model's device.  ``rng``: a
        ``torch.Generator`` on that device, or an int seed for one."""
        if not isinstance(rng, torch.Generator):
            rng = torch.Generator(device=self.device).manual_seed(int(rng))
        if rng.device.type != self.device.type:
            raise ValueError(f"generator on {rng.device}, model on "
                             f"{self.device}")
        return init_tree(rng, self.param_specs(), self.param_dtype)

    def axes(self):
        """The logical axes of every parameter (the tree of ``init``)."""
        return map_specs(lambda s: s.axes, self.param_specs())

    def param_shapes(self):
        """``meta`` tensors of ``param_dtype`` shaped as the parameters."""
        return param_shapes(self.param_specs(), self.param_dtype)

    def num_params(self) -> int:
        return sum(math.prod(s.shape) for s in spec_leaves(self.param_specs()))

    # -- forward -----------------------------------------------------------

    def _constrain(self):
        """The activation constraint of the mesh and rules (``None`` off a
        mesh), as the reference's."""
        if self.mesh is None:
            return None
        mesh, rules = self.mesh, self.rules
        return lambda x, axes: shd.constrain(x, mesh, axes, rules)

    def _tensor(self, x):
        """A batch leaf on the model's device (a DTensor as it is)."""
        return x if shd.is_dtensor(x) else torch.as_tensor(
            x, device=self.device)

    def _input(self, batch, key):
        """``batch[key]`` (frames or patches) on the model's device, cast to
        ``act_dtype``."""
        return self._tensor(batch[key]).to(self.act_dtype)

    def _embed(self, params, tokens):
        tokens = self._tensor(tokens).long()
        if self.mesh is not None:
            return shd.embed_lookup(params["embedding"], tokens).to(
                self.act_dtype)
        return embed_tokens(params, tokens).to(self.act_dtype)

    def _logits(self, params, x):
        x = apply_norm(self.cfg, params["final_norm"], x)
        return matmul(x, self._unembed(params))

    def _unembed(self, params):
        """The unembedding matrix in ``act_dtype`` (on a mesh gathered over
        the data axes, as FSDP gathers it)."""
        return shd.fsdp_gather(unembed_matrix(self.cfg, params)).to(
            self.act_dtype)

    def _prefix(self, params, batch):
        """The backbone's input: the token embeddings, after the patch
        embeddings of a vision model."""
        x = self._embed(params, batch["tokens"])
        if self.cfg.frontend == "vision":
            x = torch.cat([self._input(batch, "patches"), x], 1)
        con = self._constrain()
        if con is not None:
            x = con(x, ("batch", "seq", "act_embed"))
        return x

    def _mesh_kw(self):
        return dict(mesh=self.mesh, rules=self.rules)

    def _hidden_train(self, params, batch):
        """Returns (hidden_for_loss, targets, aux)."""
        cfg = self.cfg
        con = self._constrain()
        targets = self._tensor(batch["targets"])
        if cfg.encoder_decoder:
            enc = tfm.apply_encoder(cfg, params, self._input(batch, "frames"),
                                    impl=self.impl, remat=self.remat,
                                    constrain=con)
            tok = self._embed(params, batch["tokens"])
            tok = tok + sinusoidal_positions(
                tok.shape[1], cfg.d_model, tok.device).to(tok.dtype)
            h = tfm.apply_decoder(cfg, params, tok, enc, impl=self.impl,
                                  remat=self.remat, constrain=con)
            h = apply_norm(cfg, params["final_norm"], h)
            return h, targets, torch.zeros((), device=self.device)
        x, aux = tfm.apply_stack(cfg, params, self._prefix(params, batch),
                                 impl=self.impl, remat=self.remat,
                                 constrain=con, **self._mesh_kw())
        x = apply_norm(cfg, params["final_norm"], x)
        if cfg.frontend == "vision":
            # the rows of the last patch and every token but the last, as
            # the reference reads them
            P, St = cfg.num_prefix_embeds, targets.shape[1]
            x = x[:, P - 1:P - 1 + St]
        return x, targets, aux

    def loss(self, params, batch):
        """Mean next-token cross entropy plus the MoE aux loss (the layers'
        load-balance and z losses summed; 0 without experts).  Returns
        (ce + aux, {"ce": ce, "aux": aux}), 0-d float32 tensors."""
        with shd.on_mesh(self.mesh):
            return self._loss(params, batch)

    def _loss(self, params, batch):
        h, targets, aux = self._hidden_train(params, batch)
        w = self._unembed(params)
        loss_sum, count = chunked_cross_entropy(h, w, targets,
                                                chunk=self.cfg.loss_chunk)
        loss = loss_sum / torch.clamp_min(count, 1.0)
        return loss + aux, {"ce": loss, "aux": aux}

    def prefill(self, params, batch):
        """Full-prompt forward; returns (last_logits (B,1,V), decode_state).
        An encoder-decoder's prefill encodes the frames and decodes the
        prompt's first token (the reference feeds it no more)."""
        with tracing.span("model.prefill"), shd.on_mesh(self.mesh):
            return self._prefill(params, batch)

    def _prefill(self, params, batch):
        cfg = self.cfg
        if cfg.encoder_decoder:
            frames = self._input(batch, "frames")
            enc = tfm.apply_encoder(cfg, params, frames, impl=self.impl,
                                    remat=False, constrain=self._constrain())
            tokens = self._tensor(batch["tokens"])
            state = self._encdec_state(params, enc, tokens.shape[0],
                                       frames.shape[1] // cfg.decoder_len_ratio)
            return self._decode_step(params, state, tokens[:, :1])
        x = self._prefix(params, batch)
        S = x.shape[1]
        x, state = tfm.prefill_stack(cfg, params, x,
                                     cache_len=S + (self.decode_margin or S),
                                     impl=self.impl, dtype=self._state_dtype,
                                     constrain=self._constrain(),
                                     **self._mesh_kw())
        return self._logits(params, x[:, -1:]), state

    # -- decode ------------------------------------------------------------

    @property
    def _state_dtype(self):
        return (torch.bfloat16 if self.act_dtype == torch.bfloat16
                else torch.float32)

    def init_decode_state(self, batch_size: int, max_len: int, device=None):
        """An empty decode state on ``device`` (``None``: the model's)."""
        cfg, dt = self.cfg, self._state_dtype
        dev = device or self.device
        if cfg.encoder_decoder:
            dec_len = max(max_len // cfg.decoder_len_ratio, 8)
            shape = (batch_size, max_len, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
            cross = [{"k": torch.zeros(shape, dtype=dt, device=dev),
                      "v": torch.zeros(shape, dtype=dt, device=dev)}
                     for _ in range(cfg.num_layers)]
            return {"cross": cross, "self": self._self_state(
                batch_size, dec_len, dev)}
        return tfm.init_stack_state(cfg, batch_size, max_len, device=dev,
                                    dtype=dt)

    def decode_state_axes(self):
        """The logical axes of the decode state (the tree of
        ``init_decode_state``)."""
        cfg = self.cfg
        if cfg.encoder_decoder:
            kv_ax = {"k": ("batch", "seq", "kv_heads", "head_dim"),
                     "v": ("batch", "seq", "kv_heads", "head_dim")}
            self_ax = tfm.layer_state_axes(cfg, "attn")
            return {"cross": [kv_ax] * cfg.num_layers,
                    "self": [self_ax] * cfg.num_layers}
        return tfm.stack_state_axes(cfg)

    def decode_state_specs(self, shape: ShapeConfig):
        """``meta`` tensors shaped as the decode state of ``shape``."""
        return self.init_decode_state(shape.global_batch, shape.seq_len,
                                      device="meta")

    def _self_state(self, batch: int, dec_len: int, device=None) -> list:
        return [tfm.init_layer_state(self.cfg, "attn", batch, dec_len,
                                     device or self.device,
                                     self._state_dtype)
                for _ in range(self.cfg.num_layers)]

    def _encdec_state(self, params, enc_out, batch: int, dec_len: int):
        """The decode state after encoding: each decoder layer's
        cross-attention K/V of ``enc_out`` and an empty self-attention ring
        of ``dec_len`` slots."""
        dt = self._state_dtype
        cross = []
        for lp in params["decoder"]:
            k, v = attn_mod.encode_kv(self.cfg, lp["xattn"], enc_out)
            cross.append({"k": k.to(dt), "v": v.to(dt)})
        return {"cross": cross, "self": self._self_state(batch, dec_len)}

    def decode_step(self, params, state, tokens):
        """tokens: (B,1) -> (logits (B,1,V), new_state)."""
        with tracing.span("model.decode_step"), shd.on_mesh(self.mesh):
            return self._decode_step(params, state, tokens)

    def _decode_step(self, params, state, tokens):
        cfg = self.cfg
        x = self._embed(params, tokens)
        con = self._constrain()
        if con is not None:
            x = con(x, ("batch", "seq", "act_embed"))
        if not cfg.encoder_decoder:
            x, state = tfm.decode_stack(cfg, params, x, state,
                                        impl=self.impl, **self._mesh_kw())
            return self._logits(params, x), state
        # the token's position from the device (no host read)
        x = x + _sinusoid_at(state["self"][0]["pos"], cfg.d_model).to(x.dtype)
        new_self = []
        for lp, st, cr in zip(params["decoder"], state["self"],
                              state["cross"]):
            h, st = attn_mod.decode_self_attention(
                cfg, lp["attn"], apply_norm(cfg, lp["ln1"], x), st, window=0,
                impl=self.impl)
            x = x + h
            x = x + attn_mod.cross_attention(
                cfg, lp["xattn"], apply_norm(cfg, lp["ln_x"], x), cr["k"],
                cr["v"], impl=self.impl)
            x = x + apply_mlp(cfg, lp["mlp"], apply_norm(cfg, lp["ln2"], x))
            new_self.append(st)
        return self._logits(params, x), {"cross": state["cross"],
                                         "self": new_self}

    # -- input specs ---------------------------------------------------------

    def input_specs(self, shape: ShapeConfig):
        """Stand-ins for every model input: tensors on the ``meta`` device
        (shape and dtype, no storage), the counterpart of the reference's
        ``jax.ShapeDtypeStruct``s; frames and patches of ``act_dtype``."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len

        def tok(b, s):
            return torch.empty((b, s), dtype=torch.int32, device="meta")

        def emb(b, s):
            return torch.empty((b, s, cfg.d_model), dtype=self.act_dtype,
                               device="meta")

        if shape.kind == "decode":
            return {"tokens": tok(B, 1)}
        if cfg.encoder_decoder:
            St = S // cfg.decoder_len_ratio
            d = {"frames": emb(B, S), "tokens": tok(B, St)}
        elif cfg.frontend == "vision":
            St = S - cfg.num_prefix_embeds
            d = {"patches": emb(B, cfg.num_prefix_embeds),
                 "tokens": tok(B, St)}
        else:
            St = S
            d = {"tokens": tok(B, S)}
        if shape.kind == "train":
            d["targets"] = tok(B, St)
        return d

    def input_axes(self, shape: ShapeConfig):
        """Logical axes matching ``input_specs``."""
        return {k: ("batch", "seq", "act_embed") if k in ("frames", "patches")
                else ("batch", "seq") for k in self.input_specs(shape)}


def _sinusoid_at(pos, d: int):
    """(d,) fp32 sinusoidal position of the 0-d int tensor ``pos``,
    computed on its device."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
    ang = pos.float() / torch.pow(10000.0, dim / d)
    # sines at the even entries, cosines at the odd (out of place, so a
    # DTensor position goes through)
    return torch.stack([torch.sin(ang), torch.cos(ang)], -1).reshape(-1)[:d]


def build_model(cfg: ModelConfig, **kw) -> Model:
    return Model(cfg, **kw)
