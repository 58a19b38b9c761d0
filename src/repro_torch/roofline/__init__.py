"""The roofline bridge on the H100: what a step costs and how long it must
take.

* ``cost``     — ``analyze``: run a step once on its device and count its
  FLOPs, bytes, collectives and hand-written kernel launches (the
  counterpart of the reference's HLO walk, ``hlo_cost``).
* ``analysis`` — the config counts (``model_flops``, ...) and
  ``roofline_report``: compute, memory and collective terms on the H100's
  peaks (``repro_torch.launch.mesh``).

``repro_torch.core.schedule.plan_from_roofline`` turns a report's terms
into the paper's HFL schedule.
"""
from repro_torch.roofline.analysis import (collective_bytes_from_trace,
                                           model_flops, record_from_trace,
                                           roofline_report)
from repro_torch.roofline.cost import CostWalk, analyze

__all__ = ["CostWalk", "analyze", "collective_bytes_from_trace",
           "model_flops", "record_from_trace", "roofline_report"]
