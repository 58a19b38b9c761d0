"""Three-layer hierarchical FL runtime (Alg. 1), synchronous and async,
with injected faults and sampled cohorts, on one device or a mesh of
ranks; and the SPMD backend (one UE a rank).

* ``aggregate`` — weighted model averaging, eqs. (6)/(10), over stacked
  parameter dicts or the flat ``(N, F_total)`` buffer (one kernel launch
  per event); the async staleness merge, survivor weights and the
  streaming edge accumulator.
* ``flatten``   — flat-buffer packing of stacked parameter dicts, in the
  JAX package's leaf order, and its padded, group-aligned form on a mesh
  (``ShardedFlatLayout``).
* ``clients``   — the local solvers: full-batch GD (paper) and DANE.
* ``sampling``  — per-round client sampling (Gumbel-top-k within each
  edge: uniform, weight-proportional, Pareto) and the mass-preserving
  cohort reweighting ``participation_weights``.
* ``sim``       — simulation backend over stacked UE replicas with a
  simulated wall clock driven by the delay model (Figs. 4/6), with the
  async replay hooks the always-on service drives
  (``repro_torch.launch.service``) and a ``params`` setter for restoring
  checkpointed replicas.
* ``spmd``      — the schedule as collectives on an ('edge', 'ue') mesh
  of ranks (``make_hfl_cloud_round``), and the HFL-scheduled train step
  of the transformer substrate (``make_local_sgd_train_step``).
"""
from repro_torch.fl.aggregate import (StreamingEdgeAccumulator,
                                      flat_cloud_aggregate,
                                      flat_edge_aggregate,
                                      flat_staleness_merge,
                                      psum_staleness_merge,
                                      stacked_weighted_average,
                                      streaming_edge_aggregate,
                                      survivor_weights, weighted_average)
from repro_torch.fl.flatten import FlatLayout, ShardedFlatLayout
from repro_torch.fl.sampling import (ClientSampler, make_sampler,
                                     participation_weights)
from repro_torch.fl.sim import HFLSimulator, SimResult

__all__ = ["StreamingEdgeAccumulator", "flat_cloud_aggregate",
           "flat_edge_aggregate", "flat_staleness_merge",
           "psum_staleness_merge",
           "stacked_weighted_average", "streaming_edge_aggregate",
           "survivor_weights", "weighted_average", "FlatLayout",
           "ShardedFlatLayout", "ClientSampler", "make_sampler",
           "participation_weights", "HFLSimulator", "SimResult"]
