"""Flat-buffer packing of stacked parameter dicts — the aggregation
hot-path layout, ported from the JAX package's ``repro/fl/flatten.py``.

Every aggregation event in Alg. 1 (edge eq. 6, cloud eq. 10) is a weighted
mean over the leading UE axis of EVERY leaf.  Packing the stacked
parameters into one contiguous ``(N, F_total)`` fp32 buffer turns each
event into a single kernel launch over the whole model.

Parameters are nested dicts of tensors.  The leaf order is
``jax.tree.flatten``'s, which visits dict keys in SORTED order at every
level, so the buffer is column for column the JAX package's.  (PyTorch's
own pytrees keep insertion order instead, which would not match.)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


def _items(tree, prefix=()):
    """(path, leaf) pairs in ``jax.tree.flatten`` order: sorted dict keys."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, in ``jax.tree.flatten`` order."""
    return [leaf for _, leaf in _items(tree)]


def _unflatten(paths, leaves) -> dict:
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    paths: Tuple[tuple, ...]       # key path of each leaf, in flat order
    shapes: Tuple[tuple, ...]      # trailing (per-UE) shape of each leaf
    dtypes: Tuple[torch.dtype, ...]
    sizes: Tuple[int, ...]         # prod(shape) per leaf
    offsets: Tuple[int, ...]       # start column of each leaf
    total: int                     # F_total

    @classmethod
    def of(cls, stacked) -> "FlatLayout":
        """Layout of a STACKED dict (every leaf ``(N, *shape)``)."""
        items = list(_items(stacked))
        return cls._build([p for p, _ in items],
                          [tuple(l.shape[1:]) for _, l in items],
                          [l.dtype for _, l in items])

    @classmethod
    def of_single(cls, params) -> "FlatLayout":
        """Layout of an UNSTACKED dict (one model, no UE axis)."""
        items = list(_items(params))
        return cls._build([p for p, _ in items],
                          [tuple(l.shape) for _, l in items],
                          [l.dtype for _, l in items])

    @classmethod
    def _build(cls, paths, shapes, dtypes) -> "FlatLayout":
        sizes = tuple(math.prod(s) for s in shapes)
        offsets = tuple(sum(sizes[:i]) for i in range(len(sizes)))
        return cls(paths=tuple(paths), shapes=tuple(shapes),
                   dtypes=tuple(dtypes), sizes=sizes, offsets=offsets,
                   total=sum(sizes))

    def _leaves(self, tree) -> list:
        items = list(_items(tree))
        if tuple(p for p, _ in items) != self.paths:
            raise ValueError("parameter dict does not match this layout")
        return [l for _, l in items]

    # -- stacked round-trip ---------------------------------------------

    def ravel(self, stacked) -> torch.Tensor:
        """Pack a stacked dict into one contiguous ``(N, F_total)`` fp32
        buffer."""
        leaves = self._leaves(stacked)
        n = leaves[0].shape[0]
        return torch.cat([l.reshape(n, -1).to(torch.float32)
                          for l in leaves], dim=1)

    def unravel(self, buf: torch.Tensor) -> dict:
        """Inverse of ``ravel``: restore per-leaf shapes AND dtypes.

        An fp32 leaf comes back as a VIEW into ``buf``'s columns, so an
        in-place update of the leaf writes the buffer (the simulator's
        local GD steps rely on this)."""
        n = buf.shape[0]
        leaves = [buf[:, o:o + s].view((n,) + shp).to(dt)
                  for o, s, shp, dt in zip(self.offsets, self.sizes,
                                           self.shapes, self.dtypes)]
        return _unflatten(self.paths, leaves)

    # -- single-model round-trip (eval boundaries) ----------------------

    def ravel_single(self, params) -> torch.Tensor:
        """One UNSTACKED model -> (F_total,) fp32 vector."""
        return torch.cat([l.reshape(-1).to(torch.float32)
                          for l in self._leaves(params)])

    def unravel_single(self, vec: torch.Tensor) -> dict:
        """Inverse of ``ravel_single``: restore leaf shapes AND dtypes."""
        leaves = [vec[o:o + s].view(shp).to(dt)
                  for o, s, shp, dt in zip(self.offsets, self.sizes,
                                           self.shapes, self.dtypes)]
        return _unflatten(self.paths, leaves)
