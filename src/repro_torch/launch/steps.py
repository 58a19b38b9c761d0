"""Step assembly for the transformer stack: the greedy serving step.
Ported from the JAX package's ``repro/launch/steps.py::make_serve_step``;
the sharding helpers there are mesh-only and the train step waits for the
training slice (ROADMAP Queue 1 item 14)."""
from __future__ import annotations

import torch


def make_serve_step(model):
    def serve_step(params, state, tokens):
        logits, state = model.decode_step(params, state, tokens)
        next_tok = torch.argmax(logits, -1).to(torch.int32)
        return next_tok, state

    return serve_step
