"""The paper's contribution: hierarchical-FL time minimization.

* ``problem``  — HFLProblem: wireless/compute topology (§III, §V-A).
* ``delay``    — delay model eqs. (1)-(8), objective (13)/(15), the async
  completion time and its distributions under per-cycle draws.
* ``iteropt``  — sub-problem I: optimal (a, b); Alg. 2 dual + direct solver.
* ``assoc``    — sub-problem II: Alg. 3 association + baselines.
* ``schedule`` — HFLSchedule, ``plan``, ``plan_joint`` and the roofline
  bridge (``problem_from_roofline``, ``plan_from_roofline``).
* ``events``   — BEYOND-PAPER event-driven async edge-round timeline with
  SSP staleness gating (degenerates to the eq. 34 barrier at bound 0).
* ``stochastic`` — BEYOND-PAPER per-cycle delay draws: ``DelayModel``
  samplers on a keyed torch ``Key`` and the named ``Scenario`` registry.
* ``faults``   — BEYOND-PAPER fault injection and handling: the processes
  (dropout, churn, uplink loss, edge outages) on the same keys, the
  ``FaultPolicy`` (wait-for-all or deadline + failover) and
  ``faulty_cycle_stats``, the one draw a faulty run prices its clock with;
  ``delay.faulty_async_completion`` and ``assoc.failover`` consume it.
* ``jointopt`` — BEYOND-PAPER joint (a, b, max_staleness, bandwidth)
  search against the q-quantile async time-to-target under a scenario,
  on one keyed batch of common random numbers (``solve_joint``), with the
  per-cell bandwidth waterfilling ``optimize_bandwidth``.

``stochastic`` and ``faults`` draw with torch; the other modules are
numpy/scipy only, and ``DeterministicDelays`` stays in float64 numpy.
"""
from repro_torch.core.events import AsyncTimeline, simulate_async
from repro_torch.core.faults import (FaultModel, FaultPolicy,
                                     deadline_failover_policy,
                                     faulty_cycle_stats,
                                     wait_for_all_policy)
from repro_torch.core.problem import HFLProblem
from repro_torch.core.schedule import (HFLSchedule, plan, plan_from_roofline,
                                       plan_joint, problem_from_roofline)
from repro_torch.core.stochastic import (SCENARIOS, DelayModel,
                                         DeterministicDelays, Scenario,
                                         scenario)

__all__ = ["AsyncTimeline", "DelayModel", "DeterministicDelays",
           "FaultModel", "FaultPolicy", "HFLProblem", "HFLSchedule",
           "SCENARIOS", "Scenario", "deadline_failover_policy",
           "faulty_cycle_stats", "plan", "plan_from_roofline", "plan_joint",
           "problem_from_roofline", "scenario", "simulate_async",
           "wait_for_all_policy"]
