"""Public model API of the transformer stack: ``build_model(cfg) -> Model``.
Ported from the JAX package's ``repro/models/model.py``: ``param_specs``,
``init``, ``axes``, ``num_params``, the training loss (``loss``, through
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
Parameters, activations and the decode state are fp32 (the reference's
default ``param_dtype``/``act_dtype``), and prefill sizes the caches of
global-attention layers for one more prompt length (its default
``decode_margin``).  ``remat=True`` (the reference's default) recomputes
each layer's activations in the backward (``torch.utils.checkpoint``).

Only plain-token models are ported, dense, MoE (``models/moe.py``) and
xLSTM alike: the encoder-decoder and vision configs raise
``NotImplementedError`` (ROADMAP Queue 1 item 14).

Batch layouts (see ``input_specs``):
  train   {'tokens', 'targets': (B, S) int}
  prefill {'tokens': (B, S) int}
  decode  {'tokens': (B, 1)} with a separate decode-state tree
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (
    apply_norm, embed_specs, embed_tokens, init_tree, map_specs, norm_specs,
    spec_leaves, unembed_matrix,
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
        logits = (h @ w_unembed).to(torch.float32)
        lse = torch.logsumexp(logits, -1)
        ll = torch.gather(logits, -1, t.long()[..., None])[..., 0]
        loss = loss + torch.sum((lse - ll) * m)
        count = count + torch.sum(m)
    return loss, count


class Model:
    def __init__(self, cfg: ModelConfig, *, impl: str = "kernel",
                 remat: bool = True, device=None):
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        if cfg.frontend:
            raise NotImplementedError(
                f"the {cfg.frontend!r} frontend is not ported to repro_torch "
                "yet (ROADMAP Queue 1 item 14)")
        tfm.check_config(cfg)
        self.cfg = cfg
        self.impl = impl
        self.remat = remat
        self.device = resolve_device(device)

    # -- params ------------------------------------------------------------

    def param_specs(self):
        s: Dict[str, Any] = dict(embed_specs(self.cfg))
        s["final_norm"] = norm_specs(self.cfg)
        s.update(tfm.stack_specs_tree(self.cfg))
        return s

    def init(self, rng):
        """Parameters on the model's device.  ``rng``: a ``torch.Generator``
        on that device, or an int seed for one."""
        if not isinstance(rng, torch.Generator):
            rng = torch.Generator(device=self.device).manual_seed(int(rng))
        if rng.device.type != self.device.type:
            raise ValueError(f"generator on {rng.device}, model on "
                             f"{self.device}")
        return init_tree(rng, self.param_specs())

    def axes(self):
        """The logical axes of every parameter (the tree of ``init``)."""
        return map_specs(lambda s: s.axes, self.param_specs())

    def num_params(self) -> int:
        return sum(math.prod(s.shape) for s in spec_leaves(self.param_specs()))

    # -- forward -----------------------------------------------------------

    def _embed(self, params, tokens):
        tokens = torch.as_tensor(tokens, device=self.device).long()
        return embed_tokens(params, tokens)

    def _logits(self, params, x):
        x = apply_norm(self.cfg, params["final_norm"], x)
        return x @ unembed_matrix(self.cfg, params)

    def _hidden_train(self, params, batch):
        """Returns (hidden_for_loss, targets, aux)."""
        x = self._embed(params, batch["tokens"])
        x, aux = tfm.apply_stack(self.cfg, params, x, impl=self.impl,
                                 remat=self.remat)
        x = apply_norm(self.cfg, params["final_norm"], x)
        return x, torch.as_tensor(batch["targets"], device=self.device), aux

    def loss(self, params, batch):
        """Mean next-token cross entropy plus the MoE aux loss (the layers'
        load-balance and z losses summed; 0 without experts).  Returns
        (ce + aux, {"ce": ce, "aux": aux}), 0-d float32 tensors."""
        h, targets, aux = self._hidden_train(params, batch)
        w = unembed_matrix(self.cfg, params)
        loss_sum, count = chunked_cross_entropy(h, w, targets,
                                                chunk=self.cfg.loss_chunk)
        loss = loss_sum / torch.clamp_min(count, 1.0)
        return loss + aux, {"ce": loss, "aux": aux}

    def prefill(self, params, batch):
        """Full-prompt forward; returns (last_logits (B,1,V), decode_state)."""
        x = self._embed(params, batch["tokens"])
        x, state = tfm.prefill_stack(self.cfg, params, x,
                                     cache_len=2 * x.shape[1], impl=self.impl)
        return self._logits(params, x[:, -1:]), state

    # -- decode ------------------------------------------------------------

    def init_decode_state(self, batch_size: int, max_len: int):
        return tfm.init_stack_state(self.cfg, batch_size, max_len,
                                    device=self.device)

    def decode_step(self, params, state, tokens):
        """tokens: (B,1) -> (logits (B,1,V), new_state)."""
        x = self._embed(params, tokens)
        x, state = tfm.decode_stack(self.cfg, params, x, state,
                                    impl=self.impl)
        return self._logits(params, x), state

    # -- input specs ---------------------------------------------------------

    def input_specs(self, shape: ShapeConfig):
        """Stand-ins for every model input: tensors on the ``meta`` device
        (shape and dtype, no storage), the counterpart of the reference's
        ``jax.ShapeDtypeStruct``s."""
        B, S = shape.global_batch, shape.seq_len

        def tok(b, s):
            return torch.empty((b, s), dtype=torch.int32, device="meta")

        if shape.kind == "decode":
            return {"tokens": tok(B, 1)}
        d = {"tokens": tok(B, S)}
        if shape.kind == "train":
            d["targets"] = tok(B, S)
        return d

    def input_axes(self, shape: ShapeConfig):
        """Logical axes matching ``input_specs``."""
        return {k: ("batch", "seq") for k in self.input_specs(shape)}


def build_model(cfg: ModelConfig, **kw) -> Model:
    return Model(cfg, **kw)
