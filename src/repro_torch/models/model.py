"""Public model API of the transformer stack: ``build_model(cfg) -> Model``.
Ported from the JAX package's ``repro/models/model.py``, serving half:
``param_specs``, ``init``, ``num_params``, ``prefill``,
``init_decode_state`` and ``decode_step``.  ``loss`` (training) waits for
the training slice (ROADMAP Queue 1 item 14).

``impl="kernel"`` (the default; the JAX package's ``impl="pallas"``) runs
prefill attention and the RG-LRU scan through ``repro_torch.kernels``:
the CUDA kernels on the card, their plain versions on the CPU.
``impl="naive"`` runs dense attention and the plain scan: the oracle.
Parameters, activations and the decode state are fp32 (the reference's
default ``param_dtype``/``act_dtype``), and prefill sizes the caches of
global-attention layers for one more prompt length (its default
``decode_margin``).

Batch layouts:
  prefill {'tokens': (B, S) int}
  decode  {'tokens': (B, 1)} with a separate decode-state tree
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (
    apply_norm, embed_specs, embed_tokens, init_tree, norm_specs, spec_leaves,
    unembed_matrix,
)


class Model:
    def __init__(self, cfg: ModelConfig, *, impl: str = "kernel",
                 device=None):
        if impl not in ("kernel", "naive"):
            raise ValueError(f"impl must be 'kernel' or 'naive', got {impl!r}")
        if cfg.frontend:
            raise NotImplementedError(
                f"the {cfg.frontend!r} frontend is not ported to repro_torch "
                "yet (ROADMAP Queue 1 item 14)")
        self.cfg = cfg
        self.impl = impl
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

    def num_params(self) -> int:
        return sum(math.prod(s.shape) for s in spec_leaves(self.param_specs()))

    # -- forward -----------------------------------------------------------

    def _embed(self, params, tokens):
        tokens = torch.as_tensor(tokens, device=self.device).long()
        return embed_tokens(params, tokens)

    def _logits(self, params, x):
        x = apply_norm(self.cfg, params["final_norm"], x)
        return x @ unembed_matrix(self.cfg, params)

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
        x, state = tfm.decode_stack(self.cfg, params, x, state)
        return self._logits(params, x), state


def build_model(cfg: ModelConfig, **kw) -> Model:
    return Model(cfg, **kw)
