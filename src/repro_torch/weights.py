"""Carry parameters across from the JAX package.

The port keeps the JAX package's parameter layout (nested dicts; NHWC
images, HWIO conv weights), so its parameters, passed as numpy arrays,
load unchanged and both packages compute from the same point.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def from_jax_params(numpy_tree, device=None) -> dict:
    """Nested dict of numpy arrays (e.g. ``jax.tree.map(np.asarray,
    params)``) -> the same nested dict of tensors on ``device``, with the
    same dtypes and shapes."""
    dev = resolve_device(device)

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(vv) for k, vv in v.items()}
        return torch.as_tensor(np.array(v), device=dev)

    return conv(numpy_tree)
