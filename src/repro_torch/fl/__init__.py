"""Three-layer hierarchical FL runtime (Alg. 1), synchronous and on one
device.

* ``aggregate`` — weighted model averaging, eqs. (6)/(10), over stacked
  parameter dicts or the flat ``(N, F_total)`` buffer (one kernel launch
  per event).
* ``flatten``   — flat-buffer packing of stacked parameter dicts, in the
  JAX package's leaf order.
* ``clients``   — the local solver: full-batch GD (paper).
* ``sim``       — simulation backend over stacked UE replicas with a
  simulated wall clock driven by the delay model (Figs. 4/6).
"""
from repro_torch.fl.aggregate import (flat_cloud_aggregate,
                                      flat_edge_aggregate,
                                      stacked_weighted_average)
from repro_torch.fl.flatten import FlatLayout
from repro_torch.fl.sim import HFLSimulator, SimResult

__all__ = ["flat_cloud_aggregate", "flat_edge_aggregate",
           "stacked_weighted_average", "FlatLayout", "HFLSimulator",
           "SimResult"]
