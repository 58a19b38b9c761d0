"""Carry parameters across from the JAX package.

The port keeps the JAX package's parameter layout (nested dicts and lists;
NHWC images, HWIO conv weights; the transformer stack's ``"layers"``
list), so its parameters, passed as numpy arrays, load unchanged and both
packages compute from the same point.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def from_jax_params(numpy_tree, device=None):
    """Tree of dicts, lists and tuples of numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``) -> the same tree of tensors on
    ``device``, with the same dtypes and shapes (tuples become lists)."""
    dev = resolve_device(device)

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(vv) for k, vv in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(vv) for vv in v]
        return torch.as_tensor(np.array(v), device=dev)

    return conv(numpy_tree)
