"""Logical-axis sharding rules (MaxText-style, minimal), on a
``torch.distributed`` device mesh.

Ported rule for rule from the JAX package's ``repro/parallel/sharding.py``.
Model code annotates every parameter leaf with a tuple of LOGICAL axis
names (``Model.axes()``).  A rules table maps logical axes to mesh axes;
``spec_for`` and ``_shard_fits`` turn one annotation into a
``PartitionSpec`` (a plain tuple with the reference's entries: ``None``,
a mesh axis name, or a tuple of names), and ``logical_to_sharding`` a
tree of them into ``NamedSharding``s, whose ``placements`` are the DTensor
placements on the ``DeviceMesh``: ``Shard(dim)`` on each mesh dim that a
tensor dim takes, ``Replicate()`` on the others.  Where one tensor dim
takes two mesh axes (``batch`` takes ('pod', 'data')), the DTensor shards
it over them in mesh order, the reference's order in every rule set.

``distribute_tree`` turns full tensors into DTensors (the counterpart of
jit's ``in_shardings``), ``constrain`` redistributes an activation (the
counterpart of ``with_sharding_constraint``) and ``shard_map`` runs a
function on each rank's local shards (the counterpart of
``jax.shard_map``, through ``local_map``).  Between those points every op
of the model runs on DTensors, whose sharding propagation inserts the
collectives, as GSPMD inserts them in the reference.  The sizes of a
mesh come from a ``DeviceMesh`` or from a ``MeshShape`` (axis names and
sizes, no ranks: the counterpart of JAX's ``AbstractMesh``), so the specs
of the production meshes are computed without a process group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import Replicate

from repro_torch.launch.mesh import (DATA_AXIS, FEAT_AXIS, MODEL_AXIS,
                                     POD_AXIS, UE_AXIS)

# Default rules: FSDP over 'data', TP over 'model', DP over 'pod'.
# Params are sharded over 'data' (FSDP) on their largest non-TP dim and over
# 'model' on the TP dim; the 'pod' axis only replicates params (cloud rounds
# own it in the HFL schedule).
DEFAULT_RULES = {
    "batch": (POD_AXIS, DATA_AXIS),
    "seq": None,
    "embed": DATA_AXIS,        # FSDP dim
    "embed_nofsdp": None,
    "vocab": MODEL_AXIS,
    "mlp": MODEL_AXIS,
    "heads": MODEL_AXIS,
    "kv_heads": MODEL_AXIS,
    "head_dim": None,
    "expert": None,            # baseline: experts replicated, TP inside
    "expert_mlp": MODEL_AXIS,
    "layer": None,
    "conv": None,
    "state": None,
    "act_embed": None,         # activation d_model dim
    "act_heads": MODEL_AXIS,   # activation heads dim
    "act_seq": None,           # residual-stream seq dim between layers
    # Flat (N, F_total) aggregation buffer (repro_torch.fl.flatten): clients
    # over the data axis, features over the tensor-parallel axis.
    UE_AXIS: DATA_AXIS,
    FEAT_AXIS: MODEL_AXIS,
}

# Variant rule sets.
EXPERT_PARALLEL_RULES = dict(
    DEFAULT_RULES, expert=MODEL_AXIS, expert_mlp=None
)
NO_FSDP_RULES = dict(DEFAULT_RULES, embed=None)
SEQ_SHARDED_RULES = dict(DEFAULT_RULES, seq=DATA_AXIS)
# Megatron-style sequence parallelism for the residual stream: the
# layer-boundary activation shards its seq dim over the TP axis.
SEQ_PARALLEL_RULES = dict(DEFAULT_RULES, act_seq=MODEL_AXIS)
# ZeRO-3 / pure-FSDP: batch over BOTH mesh axes, params sharded as DEFAULT,
# activations carry no TP dims.
PURE_FSDP_RULES = dict(DEFAULT_RULES, batch=(POD_AXIS, DATA_AXIS, MODEL_AXIS),
                       act_heads=None, act_seq=None)
# Decode-time KV-cache sharding: shard the cache SEQUENCE dim over 'model'
# where kv_heads cannot divide it.
KV_SEQ_SHARDED_RULES = dict(DEFAULT_RULES, seq=MODEL_AXIS)

#: The rule sets by the dry run's ``--rules`` names.
RULE_SETS = {
    "default": DEFAULT_RULES,
    "expert_parallel": EXPERT_PARALLEL_RULES,
    "no_fsdp": NO_FSDP_RULES,
    "seq_parallel": SEQ_PARALLEL_RULES,
    "pure_fsdp": PURE_FSDP_RULES,
    "kv_seq_sharded": KV_SEQ_SHARDED_RULES,
}


class PartitionSpec(tuple):
    """One entry per leading tensor dim: ``None`` (replicated), a mesh axis
    name, or a tuple of names (the dim split over them, major first);
    trailing ``None``s dropped, as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, no ranks (JAX's ``AbstractMesh``):
    enough for specs, shardings and a ``Model``'s ``*_shardings``."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device_type: str = "cpu"

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names (a ``DeviceMesh``'s ``mesh_dim_names``)."""
    if isinstance(mesh, MeshShape):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or ``MeshShape``."""
    if isinstance(mesh, MeshShape):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes_for(mesh, logical: tuple, rules) -> P:
    names = axis_names(mesh)
    mesh_axes = []
    used = set()
    for name in logical:
        ax = rules.get(name)
        if ax is None:
            mesh_axes.append(None)
            continue
        cand = ax if isinstance(ax, tuple) else (ax,)
        cand = tuple(a for a in cand if a in names and a not in used)
        if not cand:
            mesh_axes.append(None)
        else:
            used.update(cand)
            mesh_axes.append(cand if len(cand) > 1 else cand[0])
    while mesh_axes and mesh_axes[-1] is None:
        mesh_axes.pop()
    return P(*mesh_axes)


def spec_for(mesh, logical: Optional[tuple], rules=None) -> P:
    """PartitionSpec for one logical-axes annotation (divisibility is
    checked by ``_shard_fits``)."""
    rules = rules or DEFAULT_RULES
    if logical is None:
        return P()
    return _axes_for(mesh, logical, rules)


def _shard_fits(mesh, spec: P, shape) -> P:
    """Drop mesh axes whose size does not divide the corresponding dim."""
    sizes = mesh_shape(mesh)
    fixed = []
    for i, entry in enumerate(spec):
        if entry is None:
            fixed.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        keep = []
        size = shape[i]
        for a in axes:
            n = sizes[a]
            if size % n == 0 and n > 1:
                keep.append(a)
                size //= n
        fixed.append(tuple(keep) if len(keep) > 1 else (keep[0] if keep else None))
    while fixed and fixed[-1] is None:
        fixed.pop()
    return P(*fixed)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A ``PartitionSpec`` on a mesh, as ``jax.sharding.NamedSharding``;
    ``placements`` are its DTensor placements."""
    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return placements_for(self.mesh, self.spec)

    def shard_shape(self, shape) -> tuple:
        """The shape of one rank's shard of a leaf of ``shape``."""
        sizes = mesh_shape(self.mesh)
        out = list(shape)
        for i, entry in enumerate(self.spec):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    out[i] //= sizes[a]
        return tuple(out)


def placements_for(mesh, spec: P) -> tuple:
    """The DTensor placements of ``spec``: one per mesh axis, ``Shard(i)``
    where tensor dim ``i`` takes the axis, else ``Replicate()``.  A dim
    split over several axes must name them in mesh order (the DTensor
    shards a dim over its mesh dims major first)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = tuple(a for a in axes if a is not None)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis "
                             f"order {names}")
        for j in order:
            out[j] = Shard(i)
    return tuple(out)


def _is_axes(x) -> bool:
    return x is None or (isinstance(x, tuple)
                         and all(isinstance(e, (str, type(None))) for e in x))


def tree_map_axes(fn, axes_tree, *trees):
    """``fn(axes, *leaves)`` over a tree of logical-axes annotations (a
    tuple of names or ``None`` is a leaf) and trees of the same structure;
    dicts, lists and non-annotation tuples are walked."""
    if _is_axes(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        return {k: tree_map_axes(fn, v, *(t[k] for t in trees))
                for k, v in axes_tree.items()}
    if isinstance(axes_tree, (list, tuple)):
        return [tree_map_axes(fn, v, *(t[i] for t in trees))
                for i, v in enumerate(axes_tree)]
    raise TypeError(f"not an axes tree: {type(axes_tree)}")


def logical_to_sharding(mesh, logical_tree, shape_tree=None, rules=None):
    """Map a tree of logical-axes tuples to ``NamedSharding``s.

    If ``shape_tree`` (a matching tree of tensors, ``meta`` ones included)
    is given, axes that do not divide evenly are dropped per leaf instead of
    erroring: needed for e.g. 8 experts on a 16-way model axis or kv_heads
    < model."""
    rules = rules or DEFAULT_RULES

    def one(logical, leaf=None):
        spec = spec_for(mesh, logical, rules)
        if leaf is not None:
            spec = _shard_fits(mesh, spec, leaf.shape)
        return NamedSharding(mesh, spec)

    if shape_tree is None:
        return tree_map_axes(one, logical_tree)
    return tree_map_axes(one, logical_tree, shape_tree)


def flat_buffer_spec(mesh, rules=None) -> P:
    """PartitionSpec of the flat (N, F_total) aggregation buffer on ``mesh``:
    UE rows over the data axis, feature columns over the model axis (only
    the axes present in the mesh)."""
    return spec_for(mesh, (UE_AXIS, FEAT_AXIS), rules)


def flat_buffer_row_spec(mesh, rules=None) -> P:
    """PartitionSpec of per-ROW vectors of the flat buffer (aggregation
    weights D_n, group ids): the buffer's leading-axis entry alone."""
    entries = tuple(flat_buffer_spec(mesh, rules))
    return P(entries[0] if entries else None)


def flat_buffer_col_spec(mesh, rules=None) -> P:
    """PartitionSpec of per-COLUMN vectors of the flat buffer (the global
    model vector of eq. 10 / the async cloud state): the buffer's feature
    -axis entry alone."""
    entries = tuple(flat_buffer_spec(mesh, rules))
    return P(entries[1]) if len(entries) > 1 else P()


def distribute_tree(mesh, tree, axes, rules=None):
    """A tree of full tensors (equal on every rank) as DTensors sharded by
    its logical ``axes`` under ``rules``, axes that do not divide dropped
    per leaf: the counterpart of jit's ``in_shardings``.  Each rank keeps
    its own shard (no collective)."""
    from torch.distributed.tensor import distribute_tensor
    shardings = logical_to_sharding(mesh, axes, tree, rules)
    return tree_map_axes(
        lambda _a, t, s: distribute_tensor(t, mesh, s.placements,
                                           src_data_rank=None),
        axes, tree, shardings)


def empty_sharded(shardings, shape_tree, device):
    """DTensors of the global shapes and dtypes of ``shape_tree`` (``meta``
    tensors) under ``shardings`` (a tree of the same structure), each rank
    holding an uninitialised shard of its ``shard_shape`` on ``device``:
    under ``FakeTensorMode`` the dry run's arguments, with no storage."""
    from torch.distributed.tensor import DTensor

    def one(s, shp):
        shape = torch.Size(shp.shape)
        local = torch.empty(s.shard_shape(shape), dtype=shp.dtype,
                            device=device)
        return DTensor.from_local(local, s.mesh, s.placements, shape=shape,
                                  stride=_contiguous_stride(shape))
    return _map2(one, shardings, shape_tree)


def _contiguous_stride(shape) -> tuple:
    return tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return [_map2(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def local_offsets(mesh, sharding: NamedSharding, shape) -> tuple:
    """This rank's (start, size) along each dim of a leaf of ``shape``
    under ``sharding`` (a dim split over several mesh axes, major first)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    start, size = [0] * len(shape), list(shape)
    for j, p in enumerate(sharding.placements):
        if isinstance(p, Shard):
            size[p.dim] //= mesh.size(j)
            start[p.dim] += coord[j] * size[p.dim]
    return tuple(zip(start, size))


def _cut(t, box):
    for d, (a, n) in enumerate(box):
        t = t.narrow(d, a, n)
    return t


def local_shard(t, mesh, sharding: NamedSharding):
    """This rank's shard (a view) of the full tensor ``t`` under
    ``sharding``."""
    return _cut(t, local_offsets(mesh, sharding, t.shape))


def init_keyed(model, seed: int, mesh=None, rules=None):
    """``model``'s parameters drawn leaf by leaf (and layer by layer, for a
    stacked leaf) on its device from generators keyed by ``(seed, leaf,
    layer)``: the distribution of ``Model.init`` (a normal truncated to
    [-2, 2] over sqrt(fan_in), drawn in fp32, rounded to ``param_dtype``),
    other draws.  On ``mesh`` each rank keeps only its shard of every draw
    (under ``rules``), so the full parameters never exist on one rank;
    off a mesh, the full parameters: the same values, so a single-device
    run holds a sharded one to the same weights."""
    from repro_torch.fl.flatten import tree_flatten, tree_unflatten
    from repro_torch.models.layers import _draw
    names, spec_leaves = tree_flatten(model.param_specs())
    dev, dt = model.device, model.param_dtype
    shard_leaves = (tree_flatten(logical_to_sharding(
        mesh, model.axes(), model.param_shapes(), rules))[1]
        if mesh is not None else None)

    def draw(spec, shape, key):
        if spec.init in ("zeros", "ones"):
            return (torch.zeros if spec.init == "zeros" else torch.ones)(
                shape, dtype=dt, device=dev)
        fan_in = spec.fan_in or (spec.shape[0] if spec.shape else 1)
        gen = torch.Generator(device=dev).manual_seed(key)
        return _draw(gen, shape, 1.0 / math.sqrt(max(fan_in, 1))).to(dt)

    out = []
    for i, spec in enumerate(spec_leaves):
        shape = tuple(spec.shape)
        box = (tuple((0, n) for n in shape) if mesh is None
               else local_offsets(mesh, shard_leaves[i], shape))
        key = (seed * 1_000_003 + i) * 4099
        if spec.axes[:1] == ("layer",):           # a layer at a time
            (a0, n0), rest = box[0], box[1:]
            local = torch.empty([n for _, n in box], dtype=dt, device=dev)
            for layer in range(a0, a0 + n0):
                local[layer - a0].copy_(_cut(draw(spec, shape[1:],
                                                  key + layer), rest))
        else:
            full = draw(spec, shape, key)
            local = _cut(full, box).contiguous() if mesh is not None else full
            del full
        if mesh is not None:
            from torch.distributed.tensor import DTensor
            local = DTensor.from_local(
                local, mesh, shard_leaves[i].placements,
                shape=torch.Size(shape), stride=_contiguous_stride(shape))
        out.append(local)
    return tree_unflatten(names, out)


def constrain(x, mesh, logical: tuple, rules=None):
    """Redistribute the DTensor ``x`` to the placements of its logical axes
    (axes that do not divide dropped), the counterpart of
    ``with_sharding_constraint``; a tensor off a mesh is returned as it
    is."""
    from torch.distributed.tensor import DTensor
    if mesh is None or not isinstance(x, DTensor):
        return x
    rules = rules or DEFAULT_RULES
    spec = _shard_fits(mesh, spec_for(mesh, logical, rules), x.shape)
    placements = placements_for(mesh, spec)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def mesh_of(x):
    """The ``DeviceMesh`` of a DTensor, or ``None`` for a plain tensor."""
    return x.device_mesh if is_dtensor(x) else None


def on_mesh(mesh):
    """The context the model's forward runs in on a mesh: plain tensors
    made inside it (positions, masks, zeros) count as replicated
    (``implicit_replication``).  A null context off a mesh."""
    import contextlib
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    if DTensor._op_dispatcher._allow_implicit_replication:
        # implicit_replication is not reentrant: its exit clears the flag
        return contextlib.nullcontext()
    return implicit_replication()


def unshard(x, *dims: int):
    """The DTensor ``x`` with tensor dims ``dims`` replicated (and any
    pending partial sum reduced); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    dims = {d % x.ndim for d in dims}
    pl = tuple(Replicate() if (isinstance(p, Shard) and p.dim in dims)
               or p.is_partial() else p for p in x.placements)
    if pl == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def batch_placements(x) -> tuple:
    """``x``'s placements with its batch (dim 0) sharding kept and every
    other mesh axis replicated."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(p if p == Shard(0) else Replicate() for p in x.placements)


def settle(x):
    """A DTensor activation with only its batch sharding kept: pending
    partial sums all-reduced, other dims gathered (a tensor-parallel
    product's output, before the residual add); a plain tensor as it is.
    DTensor would otherwise be free to reduce-scatter the sum along the
    sequence, and a later flatten of (batch, seq) then shards unevenly."""
    if not is_dtensor(x):
        return x
    pl = batch_placements(x)
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def fsdp_gather(tree):
    """A tree of parameters with every DTensor leaf gathered over the data
    axes ('pod', 'data'), its tensor-parallel sharding over 'model' kept:
    FSDP's all-gather of a layer's weights before the layer runs (its
    gradient the reduce-scatter back), as GSPMD gathers the reference's
    FSDP-sharded weights.  Plain tensors as they are."""
    from torch.utils._pytree import tree_map

    def one(t):
        if not is_dtensor(t):
            return t
        names = t.device_mesh.mesh_dim_names
        pl = tuple(Replicate() if names[j] in (POD_AXIS, DATA_AXIS) else p
                   for j, p in enumerate(t.placements))
        return t if pl == tuple(t.placements) else t.redistribute(
            t.device_mesh, pl)
    return tree_map(one, tree)


def row_parallel(h, w):
    """``h @ w`` where ``h``'s last dim and ``w``'s first are sharded over
    the same mesh axes (a tensor-parallel product's second half): each
    rank's local product, summed over those axes, the result sharded as
    ``h``'s leading dims.  Its backward needs no collective over those
    axes (the output's cotangent is the same on each of their ranks: each
    rank's own products' gradients), as GSPMD partitions such a product;
    ``psum`` inside ``shard_map`` would all-reduce the cotangent again.
    Where they are not so sharded (or off a mesh) a plain product."""
    from torch.distributed.tensor import DTensor, Shard
    if not (is_dtensor(h) and is_dtensor(w)):
        return h @ w
    mesh = h.device_mesh
    last = h.ndim - 1
    axes = [j for j, p in enumerate(h.placements)
            if isinstance(p, Shard) and p.dim == last]
    if not axes or any(w.placements[j] != Shard(0) for j in axes) or any(
            (isinstance(p, Shard) and p.dim == last) != (j in axes)
            or p.is_partial() for j, p in enumerate(h.placements)) or any(
            isinstance(p, Shard) and p.dim != 0 or p.is_partial()
            for j, p in enumerate(w.placements) if j not in axes):
        return h @ w
    names = mesh.mesh_dim_names
    out_pl = tuple(Replicate() if j in axes else p
                   for j, p in enumerate(h.placements))
    y = to_local(h, h.placements) @ to_local(w, w.placements)
    for j in axes:
        y = _SumForward.apply(y.contiguous(), _group(mesh, names[j]))
    return DTensor.from_local(y, mesh, out_pl, run_check=False)


def as_replicated(x, mesh):
    """``x`` as a DTensor on ``mesh``: a plain tensor (the same on every
    rank) replicated, a DTensor as it is."""
    if is_dtensor(x) or not isinstance(x, torch.Tensor):
        return x
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def embed_lookup(table, tokens):
    """``table[tokens]``; on a mesh the vocab-parallel lookup (Megatron's):
    the table gathered over the data axes, each rank looking up the
    tokens of its own slice of the vocabulary (others read as zeros), the
    rows summed over the axes the vocabulary is sharded on.  The result
    is sharded as the tokens' batch.  (DTensor's own index and its
    backward are not taken: some versions' index_put strategy fails.)"""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Shard
    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    table = fsdp_gather(table)
    tokens = as_replicated(tokens, mesh)
    tok_pl = batch_placements(tokens)
    vocab = [j for j, p in enumerate(table.placements) if p == Shard(0)]
    out_pl = tok_pl

    def local(tok, tab):
        if not vocab:
            return tab[tok]
        n_loc = tab.shape[0]
        coord = mesh.get_coordinate()
        idx = 0
        for j in vocab:
            idx = idx * mesh.size(j) + coord[j]
        ids = tok - idx * n_loc
        ok = (ids >= 0) & (ids < n_loc)
        out = tab[ids.clamp(0, n_loc - 1)] * ok[..., None].to(tab.dtype)
        for j in vocab:
            out = psum(out, mesh, names[j])
        return out
    return shard_map(local, mesh, (tok_pl, tuple(table.placements)),
                     out_pl)(tokens, table)


def full(x):
    """The whole of ``x`` on every rank: ``full_tensor()`` of a DTensor,
    a plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _replicated_size(mesh, placements) -> int:
    from torch.distributed.tensor import Replicate
    return math.prod(mesh.size(j) for j, p in enumerate(placements)
                     if isinstance(p, Replicate))


def to_local(t, placements):
    """The local shard of DTensor ``t`` redistributed to ``placements``;
    its gradient is summed over the mesh axes it is replicated on (the
    transpose ``shard_map`` takes, below)."""
    from torch.distributed.tensor import Partial, Replicate
    grad = tuple(Partial() if isinstance(p, Replicate) else p
                 for p in placements)
    if tuple(t.placements) != tuple(placements):
        # (a redistribute to the same placements would reduce the partial
        # gradient here, where a later reduce-scatter can take it)
        t = t.redistribute(t.device_mesh, tuple(placements))
    return t.to_local(grad_placements=grad)


def from_local(t, mesh, placements):
    """A local result as a DTensor of ``placements``; its cotangent is
    divided by the size of the mesh axes it is replicated on."""
    from torch.distributed.tensor import DTensor
    n = _replicated_size(mesh, placements)
    if n > 1 and t.requires_grad:
        t = _ScaleGrad.apply(t, 1.0 / n)
    return DTensor.from_local(t, mesh, tuple(placements), run_check=False)


def shard_map(fn, mesh, in_placements, out_placements):
    """``fn`` run on each rank's local shards, the counterpart of the
    reference's ``jax.shard_map(check_vma=False)``, through
    ``local_map``.  ``in_placements``: one tuple of placements per
    argument (``None`` for a non-tensor), to which each DTensor argument
    is redistributed; ``out_placements``: one per output (``fn`` returns a
    tensor or a tuple of tensors).

    Gradients follow the reference's transpose of ``shard_map``: an
    output replicated over some mesh axes takes its cotangent divided by
    their size, and an input replicated over some mesh axes sums its
    cotangent over them (its gradient placement is ``Partial`` there).
    So a function whose collectives are the reference's (``psum``,
    ``all_gather``, ``all_to_all``; ``collectives`` below, each with the
    reference's transpose) has the reference's gradients."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    single = not isinstance(out_placements, tuple) or (
        out_placements and not isinstance(out_placements[0], (tuple, list)))
    outs = (out_placements,) if single else out_placements
    grad_in = tuple(None if pl is None else tuple(
        Partial() if isinstance(p, Replicate) else p for p in pl)
        for pl in in_placements)

    def body(*args):
        out = fn(*args)
        out_t = (out,) if single else tuple(out)
        scaled = []
        for t, pl in zip(out_t, outs):
            n = _replicated_size(mesh, pl)
            scaled.append(_ScaleGrad.apply(t, 1.0 / n)
                          if n > 1 and t.requires_grad else t)
        return scaled[0] if single else tuple(scaled)

    # local_map reads a list as one output's placements, a tuple as one
    # placements sequence per output
    return local_map(body, out_placements=(list(outs[0]) if single else
                                           tuple(tuple(o) for o in outs)),
                     in_placements=tuple(in_placements),
                     in_grad_placements=grad_in, device_mesh=mesh,
                     redistribute_inputs=True)


class _PSum(torch.autograd.Function):
    """``psum`` over one mesh axis; its transpose is ``psum`` too."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed._functional_collectives as fc
        ctx.group = group
        return fc.wait_tensor(fc.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        import torch.distributed._functional_collectives as fc
        return fc.wait_tensor(fc.all_reduce(g.contiguous(), "sum",
                                            ctx.group)), None


class _SumForward(torch.autograd.Function):
    """A sum over one mesh axis whose cotangent, the same on every rank of
    the axis, passes through (``row_parallel``)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed._functional_collectives as fc
        return fc.wait_tensor(fc.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def _group(mesh, axis: str):
    """A functional collective's group: the mesh and the axis's index."""
    return (mesh, tuple(mesh.mesh_dim_names).index(axis))


def psum(x, mesh, axis: str):
    """``jax.lax.psum`` over mesh axis ``axis`` inside ``shard_map``."""
    return _PSum.apply(x.contiguous(), _group(mesh, axis))


def all_gather(x, mesh, axis: str, dim: int):
    """``jax.lax.all_gather(tiled=True)`` along tensor dim ``dim`` over mesh
    axis ``axis``; its transpose is the reduce-scatter."""
    import torch.distributed._functional_collectives as fc
    out = fc.all_gather_tensor_autograd(x.contiguous(), dim,
                                        _group(mesh, axis))
    return fc.wait_tensor(out) if not out.requires_grad else out


def all_to_all(x, mesh, axis: str):
    """``jax.lax.all_to_all(split_axis=0, concat_axis=0)`` of ``x``
    (n, ...) over mesh axis ``axis`` (size n): block ``i`` goes to the
    axis's rank ``i``; the result's block ``i`` came from rank ``i``."""
    import torch.distributed._functional_collectives as fc
    n = x.shape[0]
    flat = x.reshape(n * x.shape[1], *x.shape[2:]).contiguous()
    out = fc.all_to_all_single_autograd(flat, None, None,
                                        _group(mesh, axis))
    return out.reshape(x.shape)
