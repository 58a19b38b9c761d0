"""Three-layer hierarchical FL runtime (Alg. 1), synchronous and async,
on one device; synchronous on a mesh of ranks too.

* ``aggregate`` — weighted model averaging, eqs. (6)/(10), over stacked
  parameter dicts or the flat ``(N, F_total)`` buffer (one kernel launch
  per event); the async staleness merge, survivor weights and the
  streaming edge accumulator.
* ``flatten``   — flat-buffer packing of stacked parameter dicts, in the
  JAX package's leaf order, and its padded, group-aligned form on a mesh
  (``ShardedFlatLayout``).
* ``clients``   — the local solvers: full-batch GD (paper) and DANE.
* ``sim``       — simulation backend over stacked UE replicas with a
  simulated wall clock driven by the delay model (Figs. 4/6).
"""
from repro_torch.fl.aggregate import (StreamingEdgeAccumulator,
                                      flat_cloud_aggregate,
                                      flat_edge_aggregate,
                                      flat_staleness_merge,
                                      stacked_weighted_average,
                                      streaming_edge_aggregate,
                                      survivor_weights, weighted_average)
from repro_torch.fl.flatten import FlatLayout, ShardedFlatLayout
from repro_torch.fl.sim import HFLSimulator, SimResult

__all__ = ["StreamingEdgeAccumulator", "flat_cloud_aggregate",
           "flat_edge_aggregate", "flat_staleness_merge",
           "stacked_weighted_average", "streaming_edge_aggregate",
           "survivor_weights", "weighted_average", "FlatLayout",
           "ShardedFlatLayout", "HFLSimulator", "SimResult"]
