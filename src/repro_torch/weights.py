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
    ``device``, with the same dtypes (bfloat16 included), values and shapes
    (tuples become lists)."""
    dev = resolve_device(device)

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(vv) for k, vv in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(vv) for vv in v]
        return _tensor(np.array(v)).to(dev)

    return conv(numpy_tree)


def _tensor(a: np.ndarray) -> torch.Tensor:
    """``a`` as a tensor of its dtype.  A bfloat16 array (``ml_dtypes``'
    type, which numpy and torch do not know by name) is carried over bit
    for bit through an int16 view."""
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.as_tensor(a)
