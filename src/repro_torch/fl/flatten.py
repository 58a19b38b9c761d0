"""Flat-buffer packing of stacked parameter dicts — the aggregation
hot-path layout, ported from the JAX package's ``repro/fl/flatten.py``.

Every aggregation event in Alg. 1 (edge eq. 6, cloud eq. 10) is a weighted
mean over the leading UE axis of EVERY leaf.  Packing the stacked
parameters into one contiguous ``(N, F_total)`` fp32 buffer turns each
event into a single kernel launch over the whole model.

Parameters are nested dicts (and lists, as the transformer stack's
``"layers"``) of tensors.  The leaf order is ``jax.tree.flatten``'s, which
visits dict keys in SORTED order at every level and list items in order,
so the buffer is column for column the JAX package's.  (PyTorch's
own pytrees keep insertion order instead, which would not match.)

Sharded layout (``ShardedFlatLayout``): on a ('data', 'model') mesh of
ranks (``repro_torch.launch.mesh``) the buffer is distributed without
replication, as in the reference:

* the feature axis is zero-PADDED from ``F_total`` to ``f_padded``, a
  multiple of the model-axis size, and each rank owns one contiguous
  ``f_padded / num_model`` column slab;
* the UE axis is split over 'data' after a GROUP-ALIGNED row permutation:
  edges are bin-packed onto data shards (largest group first) and every
  shard is padded with zero-weight rows to the common ``rows_per_shard``,
  so no edge straddles a shard boundary.

So edge aggregation (eq. 6) needs no collective, and the cloud mean
(eq. 10) one small all-reduce of per-shard partial sums over 'data' (see
``repro_torch.fl.aggregate``).  The padded buffer's helpers (``pad``,
``pad_rows``, ...) work on the GLOBAL padded form; ``local`` cuts a rank's
slab out of it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch


def _items(tree, prefix=()):
    """(path, leaf) pairs in ``jax.tree.flatten`` order: sorted dict keys,
    list items in order (a list's path entries are ints)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (i,))
    else:
        yield prefix, tree


def tree_leaves(tree) -> list:
    """The leaves of nested dicts and lists, in ``jax.tree.flatten``
    order."""
    return [leaf for _, leaf in _items(tree)]


def tree_flatten(tree) -> tuple:
    """(paths, leaves) of nested dicts and lists, in ``jax.tree.flatten``
    order; ``tree_unflatten(paths, leaves)`` rebuilds the tree."""
    items = list(_items(tree))
    return [p for p, _ in items], [leaf for _, leaf in items]


def tree_unflatten(paths, leaves):
    """The tree of ``leaves`` at ``paths`` (``tree_flatten``'s inverse)."""
    return _unflatten(paths, leaves)


def _unflatten(paths, leaves) -> dict:
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return _lists(out)


def _lists(node):
    """The nodes of ``_unflatten``'s dicts whose keys are list indices,
    back as lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        return [node[i] for i in range(len(node))]
    return node


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


# ---------------------------------------------------------------------------
# Mesh-sharded layout of the flat buffer.
# ---------------------------------------------------------------------------


def _pack_groups(group_ids: np.ndarray, num_shards: int):
    """Bin-pack whole groups onto ``num_shards`` row shards (LPT greedy).

    Returns (perm, n_padded): ``perm`` has length ``n_padded`` (a multiple
    of num_shards); entry i is the original row index living at padded slot
    i, or -1 for a zero-weight padding row.  Every group's rows land on
    exactly one shard, so per-shard segment means equal global ones.  The
    reference's packing to the bit (largest group first, ties in group
    order, ``np.argmin``'s first shard among equal loads)."""
    group_ids = np.asarray(group_ids)
    groups = np.unique(group_ids)
    rows = {g: np.flatnonzero(group_ids == g) for g in groups}
    order = sorted(groups, key=lambda g: -len(rows[g]))   # largest first
    bins: list = [[] for _ in range(num_shards)]
    loads = np.zeros(num_shards, dtype=np.int64)
    for g in order:
        s = int(np.argmin(loads))
        bins[s].extend(rows[g].tolist())
        loads[s] += len(rows[g])
    rows_per_shard = int(loads.max())
    perm = []
    for b in bins:
        perm.extend(b)
        perm.extend([-1] * (rows_per_shard - len(b)))
    return np.asarray(perm, dtype=np.int64), num_shards * rows_per_shard


@dataclasses.dataclass
class ShardedFlatLayout:
    """A ``FlatLayout`` distributed over a ('data', 'model') mesh of ranks.

    External API works in the ORIGINAL row order and true ``F_total``;
    the padded form is ``(n_padded, f_padded)``, whose row and column
    shards divide the mesh axes evenly.  ``mesh`` is the rank's
    ``repro_torch.launch.mesh.AggMesh``: its coordinates pick the slab
    ``local_rows`` x ``local_cols``."""
    base: FlatLayout
    mesh: object
    num_data: int
    num_model: int
    num_rows: int                   # original N
    n_padded: int
    f_padded: int
    perm: np.ndarray                # (n_padded,) original index or -1
    inv_perm: np.ndarray            # (num_rows,) padded slot of each row

    @classmethod
    def build(cls, base: FlatLayout, mesh, num_rows: int,
              group_ids: Optional[np.ndarray] = None) -> "ShardedFlatLayout":
        """Derive the padded/permuted layout for ``mesh``.

        ``group_ids`` (the eq. 6 edge of each UE row) is required whenever
        the data axis is > 1: edges are bin-packed whole onto row shards
        (``_pack_groups``) so each shard's LOCAL segment means equal the
        GLOBAL eq. 6 means.  Feature columns are zero-padded to a
        model-axis multiple (zero columns drop out of every weighted
        mean)."""
        num_data, num_model = mesh.num_data, mesh.num_model
        f_padded = -(-base.total // num_model) * num_model
        if num_data > 1:
            if group_ids is None:
                raise ValueError("data-axis sharding needs group_ids to "
                                 "keep edges whole per shard")
            if len(group_ids) != num_rows:
                raise ValueError(f"{len(group_ids)} group ids for "
                                 f"{num_rows} rows")
            perm, n_padded = _pack_groups(np.asarray(group_ids), num_data)
        else:
            perm = np.arange(num_rows, dtype=np.int64)
            n_padded = num_rows
        inv_perm = np.empty(num_rows, dtype=np.int64)
        inv_perm[perm[perm >= 0]] = np.flatnonzero(perm >= 0)
        return cls(base=base, mesh=mesh, num_data=num_data,
                   num_model=num_model, num_rows=num_rows,
                   n_padded=n_padded, f_padded=f_padded,
                   perm=perm, inv_perm=inv_perm)

    # -- the rank's slab (in place of the reference's PartitionSpecs) ---

    @property
    def local_rows(self) -> slice:
        """The padded rows this rank holds."""
        n = self.n_padded // self.num_data
        return slice(self.mesh.data_index * n, (self.mesh.data_index + 1) * n)

    @property
    def local_cols(self) -> slice:
        """The padded columns this rank holds."""
        f = self.f_padded // self.num_model
        return slice(self.mesh.model_index * f,
                     (self.mesh.model_index + 1) * f)

    def local(self, buf: torch.Tensor) -> torch.Tensor:
        """This rank's slab (a contiguous copy) of a padded global buffer
        ``(n_padded, f_padded)``, or its rows of a per-row vector
        ``(n_padded,)``."""
        if buf.dim() == 1:
            return buf[self.local_rows].contiguous()
        return buf[self.local_rows, self.local_cols].contiguous()

    def per_device_bytes(self) -> int:
        """fp32 bytes of one rank's (rows, cols) slab."""
        return (self.n_padded // self.num_data) * \
               (self.f_padded // self.num_model) * 4

    # -- padded-form helpers (permuted rows, padded columns) ------------

    def _permuted(self) -> bool:
        return self.n_padded != self.num_rows or bool(
            np.any(self.perm != np.arange(self.num_rows)))

    def _index(self, device) -> torch.Tensor:
        return torch.as_tensor(np.maximum(self.perm, 0), device=device)

    def pad(self, buf: torch.Tensor) -> torch.Tensor:
        """(N, F_total) -> padded (n_padded, f_padded); pad rows are row-0
        copies (their weight is zero wherever it matters)."""
        if self.f_padded > self.base.total:
            buf = torch.nn.functional.pad(
                buf, (0, self.f_padded - self.base.total))
        if self._permuted():
            buf = buf[self._index(buf.device)]
        return buf

    def unpad(self, buf: torch.Tensor) -> torch.Tensor:
        """Inverse of ``pad``: original row order, true F_total columns."""
        out = buf[:, :self.base.total]
        if self._permuted():
            out = out[torch.as_tensor(self.inv_perm, device=buf.device)]
        return out

    def pad_rows(self, x):
        """Permute+pad any per-row tensor or numpy array, or a dict of them
        (leading axis num_rows)."""
        if isinstance(x, dict):
            return {k: self.pad_rows(v) for k, v in x.items()}
        if isinstance(x, np.ndarray):
            return x[np.maximum(self.perm, 0)]
        return x[self._index(x.device)]

    def pad_weights(self, w) -> torch.Tensor:
        """Permute+pad the aggregation weights D_n; padding rows get
        weight 0, so they contribute nothing to the eq. 6/10 sums."""
        w = torch.as_tensor(w, dtype=torch.float32)
        keep = torch.as_tensor(self.perm >= 0, device=w.device)
        return w[self._index(w.device)] * keep.to(torch.float32)

    def pad_mask(self, mask) -> torch.Tensor:
        """Permute+pad a boolean per-row mask; pad rows get **False**.

        ``pad_rows`` pads with row-0 copies, which would mark a pad row as
        set whenever UE 0 is; this forces every pad slot to False.  Accepts
        any tensor whose LEADING axis is ``num_rows``."""
        m = torch.as_tensor(mask, dtype=torch.bool)
        keep = torch.as_tensor(self.perm >= 0, device=m.device)
        return m[self._index(m.device)] & keep.reshape(
            (-1,) + (1,) * (m.dim() - 1))

    def gather_rows(self, buf: torch.Tensor, rows) -> torch.Tensor:
        """Only the cohort ``rows`` (padded-order indices, a host int
        array) of a padded buffer: ``(len(rows), f_padded)``."""
        return buf[torch.as_tensor(np.asarray(rows, np.int64),
                                   device=buf.device)]

    def scatter_rows(self, buf: torch.Tensor, rows, values) -> torch.Tensor:
        """A copy of the padded buffer with ``values`` written at ``rows``
        (inverse of ``gather_rows``); other rows untouched."""
        out = buf.clone()
        out[torch.as_tensor(np.asarray(rows, np.int64),
                            device=buf.device)] = values
        return out

    # -- original-order round-trip --------------------------------------

    def ravel(self, stacked) -> torch.Tensor:
        """Stacked dict -> padded global buffer."""
        return self.pad(self.base.ravel(stacked))

    def unravel(self, buf: torch.Tensor) -> dict:
        """Padded global buffer -> stacked dict in original row order."""
        return self.base.unravel(self.unpad(buf))

    def ravel_padded(self, stacked) -> torch.Tensor:
        """Stacked dict ALREADY in padded row order -> padded buffer (no
        permutation, just the column pad)."""
        buf = self.base.ravel(stacked)
        if self.f_padded > self.base.total:
            buf = torch.nn.functional.pad(
                buf, (0, self.f_padded - self.base.total))
        return buf

    def unravel_padded(self, buf: torch.Tensor) -> dict:
        """Padded buffer (all ``f_padded`` columns) -> stacked dict keeping
        the padded row order.  fp32 leaves are views of ``buf``, as
        ``FlatLayout.unravel``'s are."""
        return self.base.unravel(buf)
