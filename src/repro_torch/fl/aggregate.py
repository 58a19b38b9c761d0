"""Weighted model aggregation — eqs. (6) and (10), ported from the JAX
package's ``repro/fl/aggregate.py`` (single device, no mesh).

* the FLAT buffer (``repro_torch.fl.flatten``): ``flat_edge_aggregate`` /
  ``flat_cloud_aggregate`` — the hot path, one kernel launch per event
  (``repro_torch.kernels.hier_aggregate``);
* STACKED parameter dicts whose leaves carry a leading UE axis:
  ``stacked_weighted_average`` ravels through the flat buffer.

The kernel wrappers pick the path by the buffer's device: the CUDA kernel
for a CUDA tensor, the plain PyTorch version for a CPU tensor.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.fl.flatten import FlatLayout
from repro_torch.kernels import hier_aggregate as ha


def flat_cloud_aggregate(buf: torch.Tensor, weights) -> torch.Tensor:
    """Cloud aggregation (eq. 10) over the flat buffer.

    buf: (N, F_total) fp32|bf16, weights: (N,) -> (N, F_total) fp32 with
    every row holding the global weighted mean."""
    w = torch.as_tensor(weights, dtype=torch.float32, device=buf.device)
    return ha.cloud_aggregate(buf, w.contiguous())


def flat_edge_aggregate(buf: torch.Tensor, weights, group_ids,
                        num_groups: int) -> torch.Tensor:
    """Edge aggregation (eq. 6) over the flat buffer.

    buf: (N, F_total) fp32|bf16, weights: (N,), group_ids: (N,) ints in
    [0, num_groups) -> (N, F_total) fp32 with row n holding the weighted
    mean of n's edge."""
    w = torch.as_tensor(weights, dtype=torch.float32, device=buf.device)
    g = torch.as_tensor(group_ids, dtype=torch.int32, device=buf.device)
    return ha.segment_aggregate(buf, w.contiguous(), g.contiguous(),
                                int(num_groups))


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
