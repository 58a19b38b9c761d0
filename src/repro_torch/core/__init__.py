"""The paper's contribution: hierarchical-FL time minimization.

* ``problem``  — HFLProblem: wireless/compute topology (§III, §V-A).
* ``delay``    — delay model eqs. (1)-(8), objective (13)/(15), and the
  constant-delay async completion time.
* ``iteropt``  — sub-problem I: optimal (a, b); Alg. 2 dual + direct solver.
* ``assoc``    — sub-problem II: Alg. 3 association + baselines.
* ``schedule`` — HFLSchedule and ``plan``.
* ``events``   — BEYOND-PAPER event-driven async edge-round timeline with
  SSP staleness gating (degenerates to the eq. 34 barrier at bound 0).

Every module here is numpy/scipy only; none imports torch.
"""
from repro_torch.core.events import AsyncTimeline, simulate_async
from repro_torch.core.problem import HFLProblem
from repro_torch.core.schedule import HFLSchedule, plan

__all__ = ["AsyncTimeline", "HFLProblem", "HFLSchedule", "plan",
           "simulate_async"]
