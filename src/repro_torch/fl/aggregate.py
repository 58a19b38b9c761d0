"""Weighted model aggregation — eqs. (6) and (10), ported from the JAX
package's ``repro/fl/aggregate.py``.

* list-of-dicts bookkeeping: ``weighted_average``;
* the FLAT buffer (``repro_torch.fl.flatten``): ``flat_edge_aggregate`` /
  ``flat_cloud_aggregate`` — the hot path, one kernel launch per event
  (``repro_torch.kernels.hier_aggregate``), on one device or on a
  ('data', 'model') mesh of ranks (``mesh=``, below);
* the async cloud merge ``flat_staleness_merge`` and the fault rule
  ``survivor_weights`` (plain torch, as the JAX package leaves them to
  XLA);
* STREAMING edge aggregation (``StreamingEdgeAccumulator``,
  ``streaming_edge_aggregate``): chunks of client rows fold into an
  ``(M, F)`` accumulator, one ``segment_sum`` kernel launch per chunk;
* STACKED parameter dicts whose leaves carry a leading UE axis:
  ``stacked_weighted_average`` ravels through the flat buffer.

The kernel wrappers pick the path by the buffer's device: the CUDA kernel
for a CUDA tensor, the plain PyTorch version for a CPU tensor.

Mesh sharding (``mesh=``, a ``repro_torch.launch.mesh.AggMesh``): the
multi-controller counterpart of the reference's ``shard_map``.  EVERY rank
calls the function with ITS OWN slab of the padded
``ShardedFlatLayout`` buffer (``layout.local``: its group-aligned rows,
its column slab) and its rows' weights and group ids, and gets its own
slab back.  Collective pattern, as in the reference:

* edge (eq. 6): none.  The layout keeps every edge inside one data shard,
  so each rank's local segment means ARE the global ones;
* cloud (eq. 10): with one data shard, the single-slab event on the
  column slab; with more, each rank's local weighted mean (``weighted_mean``
  kernel) times its local weight sum, 0 for an all-padding shard, meets
  the other shards' in ONE all-reduce of ``F_local + 1`` floats over
  'data' (``psum_weighted_mean``), then a local broadcast-back.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.fl.flatten import FlatLayout, _items, _unflatten, tree_leaves
from repro_torch.kernels import hier_aggregate as ha


def weighted_average(params_list: Sequence[dict], weights) -> dict:
    """eq. (6)/(10): ``sum_n D_n w_n / sum_n D_n`` over a list of
    parameter dicts; each leaf keeps its dtype."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    w = w / w.sum()
    leaves = [tree_leaves(p) for p in params_list]
    paths = [p for p, _ in _items(params_list[0])]
    out = []
    for col in zip(*leaves):
        stack = torch.stack([t.to(torch.float32) for t in col])
        out.append(torch.tensordot(w.to(stack.device), stack, dims=1)
                   .to(col[0].dtype))
    return _unflatten(paths, out)


def psum_weighted_mean(num: torch.Tensor, den: torch.Tensor,
                       group) -> torch.Tensor:
    """ONE-collective weighted mean over the ranks of ``group`` (eq. 10's
    ``sum_n D_n w_n / sum_n D_n`` with the sums split across ranks).

    ``num`` is this rank's pre-weighted numerator vector, ``den`` its
    weight sum; they are concatenated so that the reduction is a SINGLE
    all-reduce of ``len(num) + 1`` floats."""
    v = torch.cat([num, den.reshape(1).to(num.dtype)])
    dist.all_reduce(v, group=group)
    return v[:-1] / v[-1]


def flat_cloud_aggregate(buf: torch.Tensor, weights, *,
                         mesh=None) -> torch.Tensor:
    """Cloud aggregation (eq. 10) over the flat buffer.

    buf: (N, F_total) fp32|bf16, weights: (N,) -> (N, F_total) fp32 with
    every row holding the global weighted mean.

    With ``mesh``, every rank passes its own slab of the padded buffer and
    its rows' weights and gets its slab of the result: each data shard
    reduces its slab with the ``weighted_mean`` kernel and the shards meet
    in one all-reduce over 'data' (see the module docstring)."""
    w = torch.as_tensor(weights, dtype=torch.float32,
                        device=buf.device).contiguous()
    if mesh is None or mesh.num_data == 1:
        return ha.cloud_aggregate(buf, w)
    den = w.sum()
    # the local weighted mean times the local weight sum is the local
    # weighted sum; an all-padding shard (den == 0, mean 0/0) gives 0
    num = torch.where(den > 0, ha.weighted_mean(buf, w) * den, 0.0)
    mean = psum_weighted_mean(num, den, mesh.data_group)
    return mean[None].expand(buf.shape).contiguous()


def flat_edge_aggregate(buf: torch.Tensor, weights, group_ids,
                        num_groups: int, *, mesh=None) -> torch.Tensor:
    """Edge aggregation (eq. 6) over the flat buffer.

    buf: (N, F_total) fp32|bf16, weights: (N,), group_ids: (N,) ints in
    [0, num_groups) -> (N, F_total) fp32 with row n holding the weighted
    mean of n's edge.

    With ``mesh``, every rank passes its own slab and its rows' weights and
    group ids, and gets its slab back, with no collective: the rows must be
    group-aligned to the data shards (``ShardedFlatLayout`` keeps every
    edge inside one), so the local segment means are the global ones."""
    w = torch.as_tensor(weights, dtype=torch.float32, device=buf.device)
    g = torch.as_tensor(group_ids, dtype=torch.int32, device=buf.device)
    return ha.segment_aggregate(buf, w.contiguous(), g.contiguous(),
                                int(num_groups))


def flat_staleness_merge(global_vec: torch.Tensor, buf: torch.Tensor,
                         eff_weights, w_total) -> torch.Tensor:
    """Async cloud merge: staleness-weighted update of the cloud model from
    the arrived edges' rows of the flat buffer.

    global_vec:  (F,) cloud model;
    buf:         (N, F) flat buffer;
    eff_weights: (N,) effective row weights ``w_n * decay**staleness`` for
                 members of arrived edges, 0 for every other row;
    w_total:     python float, the TOTAL fleet weight ``sum_n w_n``.

        g <- (1 - Lambda) g + sum_n eff_n row_n / W,  Lambda = sum_n eff_n / W

    which is eq. 10 when every edge arrives with staleness 0 (the
    ``max_staleness=0`` barrier).  Returns a new (F,) fp32 vector."""
    eff = torch.as_tensor(eff_weights, dtype=torch.float32,
                          device=buf.device)
    w_total = float(w_total)
    num = eff @ buf.to(torch.float32)
    lam = eff.sum() / w_total
    return (1.0 - lam) * global_vec.to(torch.float32) + num / w_total


def survivor_weights(weights, survivors, group_ids,
                     num_groups: int) -> torch.Tensor:
    """Survivor weights renormalised to keep every edge's mass:

        w'_n = w_n * survivor_n * (W_m / W_m^surv),   n in edge m

    An edge with no survivors keeps all-zero weights, so with the
    ``max(gw, 1e-12)`` guard of the edge aggregation a fully-dropped cohort
    gives an exact 0, never NaN.  On the device of ``weights`` (the CPU for
    a numpy array)."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    s = torch.as_tensor(survivors, device=w.device)
    gids = torch.as_tensor(group_ids, device=w.device).long()
    ng = int(num_groups)
    masked = w * s.to(torch.float32)
    w_full = torch.zeros(ng, device=w.device).index_add_(0, gids, w)
    w_surv = torch.zeros(ng, device=w.device).index_add_(0, gids, masked)
    scale = torch.where(w_surv > 0, w_full / w_surv.clamp_min(1e-12), 0.0)
    return masked * scale[gids]


class StreamingEdgeAccumulator:
    """Chunked edge aggregation (eq. 6) whose resident state does not grow
    with N: each chunk of client rows folds into a persistent
    ``(num_groups, F)`` weighted-sum accumulator plus an ``(M,)`` mass
    vector, so the ``(N, F)`` buffer never has to exist.

    On a CUDA device each chunk's sums go through the ``segment_sum``
    kernel, which adds into the accumulator in place; on the CPU through
    its plain version.  ``device=None`` means the card (and raises without
    one).

        acc = StreamingEdgeAccumulator(num_edges, f_total)
        for rows, w, gid in arrival_waves:      # each a chunk of rows
            acc.add(rows, w, gid)
        means = acc.edge_means()                # (M, F)
    """

    def __init__(self, num_groups: int, f_total: int, *, device=None):
        self.device = resolve_device(device)
        self.num_groups = int(num_groups)
        self.f_total = int(f_total)
        self.num = torch.zeros((self.num_groups, self.f_total),
                               dtype=torch.float32, device=self.device)
        self.mass = torch.zeros(self.num_groups, dtype=torch.float32,
                                device=self.device)

    def add(self, buf: torch.Tensor, weights,
            group_ids) -> "StreamingEdgeAccumulator":
        """Fold one chunk: buf (n_chunk, F) fp32|bf16 on the accumulator's
        device, weights (n_chunk,), group_ids (n_chunk,).  Zero-weight rows
        add nothing."""
        w = torch.as_tensor(weights, dtype=torch.float32,
                            device=self.device).contiguous()
        gid = torch.as_tensor(group_ids, dtype=torch.int32,
                              device=self.device).contiguous()
        ha.segment_sum(buf, w, gid, self.num_groups, out=self.num)
        # the chunk's mass first, then added: the reference's association
        self.mass += torch.zeros_like(self.mass).index_add_(0, gid.long(), w)
        return self

    def edge_means(self) -> torch.Tensor:
        """(M, F) fp32 per-edge weighted means; an edge that never saw mass
        gives an exact 0 row."""
        mean = self.num / self.mass.clamp_min(1e-12)[:, None]
        return torch.where((self.mass > 0)[:, None], mean, 0.0)

    def cloud_mean(self) -> torch.Tensor:
        """(F,) eq. 10 over everything folded so far, from the per-edge
        sums alone."""
        return self.num.sum(0) / self.mass.sum().clamp_min(1e-12)

    def scatter(self, group_ids) -> torch.Tensor:
        """Edge means broadcast back to rows: (n,) ids -> (n, F)."""
        return self.edge_means()[torch.as_tensor(group_ids,
                                                 device=self.device).long()]

    def reset(self) -> "StreamingEdgeAccumulator":
        """Zero the accumulator for reuse."""
        self.num.zero_()
        self.mass.zero_()
        return self

    def resident_bytes(self) -> int:
        """Bytes of persistent accumulator state (independent of N)."""
        return int(self.num.numel() * 4 + self.mass.numel() * 4)


def streaming_edge_aggregate(buf: torch.Tensor, weights, group_ids,
                             num_groups: int, *,
                             chunk_size: int) -> torch.Tensor:
    """``flat_edge_aggregate`` through the streaming accumulator: folds
    ``buf`` in ``chunk_size``-row chunks and scatters the means back.
    Equals the one-shot event to fp32 reassociation."""
    n = buf.shape[0]
    chunk = max(1, int(chunk_size))
    w = torch.as_tensor(weights, dtype=torch.float32, device=buf.device)
    gid = torch.as_tensor(group_ids, dtype=torch.int32, device=buf.device)
    acc = StreamingEdgeAccumulator(int(num_groups), int(buf.shape[1]),
                                   device=buf.device)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        acc.add(buf[start:stop], w[start:stop], gid[start:stop])
    return acc.scatter(gid)


def stacked_weighted_average(stacked: dict, weights, *, group_ids=None,
                             num_groups: Optional[int] = None) -> dict:
    """Weighted mean over the leading UE axis of every leaf.

    group_ids=None      -> cloud aggregation (eq. 10): one global mean,
                           broadcast back to every UE slot.
    group_ids=(N,) ints -> edge aggregation (eq. 6): segment mean per edge,
                           broadcast back to that edge's members.

    Packs the dict into the flat ``(N, F_total)`` buffer so the whole event
    is one launch, then restores leaf dtypes/shapes."""
    layout = FlatLayout.of(stacked)
    buf = layout.ravel(stacked)
    if group_ids is None:
        out = flat_cloud_aggregate(buf, weights)
    else:
        out = flat_edge_aggregate(buf, weights, group_ids, int(num_groups))
    return layout.unravel(out)
