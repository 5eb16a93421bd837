"""``repro_torch.chaos`` — fault injection, crash recovery, offload routing.

Real serverless delivers its elasticity with failures attached; this
package makes the failure regime an explicit, seeded experiment input
and the recovery story a first-class API (ROADMAP: "Fault tolerance
and cost-aware offload routing"):

* :class:`~repro_torch.chaos.faults.FaultPlan` — declarative fault
  injection (kill-mid-task / kill-mid-batch, whole-container
  mortality, rate-limit storms, cold-start inflation) wired into any
  backend via ``make_pool(..., faults=plan)``; kills land as typed
  ``worker_killed`` events and are retried transparently, so **N%
  mortality changes cost/makespan, never results**.
* :func:`~repro_torch.chaos.recovery.recover_frontier` — master crash
  recovery: replay the ``folded`` write-ahead journal that
  ``run_irregular(..., wal=True)`` lands on the trace, reconstruct
  the pending frontier + partial accumulator, and resume with
  ``run_irregular(..., resume_from=trace)`` to a bit-identical output.
* :class:`~repro_torch.chaos.routing.RoutingPolicy` — per-task local-vs-
  elastic placement for ``HybridExecutor`` (``threshold`` / ``random``
  / ``least-loaded`` / ``cost-per-deadline``), replacing the static
  ``cost_hint`` threshold.

The dependency arrow is chaos → core/trace only: the pools duck-type
against a bound plan and never import this package.
"""
from ..core.futures import WorkerKilledError
from .faults import BoundFaults, FaultPlan
from .recovery import (FrontierRecovery, MasterKilledError,
                       kill_master_after, recover_frontier)
from .routing import (CostPerDeadlinePolicy, LeastLoadedPolicy,
                      LocalFirstPolicy, RandomPolicy, RoutingPolicy,
                      ThresholdPolicy, make_routing_policy)

__all__ = [
    "FaultPlan", "BoundFaults", "WorkerKilledError",
    "FrontierRecovery", "recover_frontier", "MasterKilledError",
    "kill_master_after",
    "RoutingPolicy", "LocalFirstPolicy", "ThresholdPolicy",
    "RandomPolicy", "LeastLoadedPolicy", "CostPerDeadlinePolicy",
    "make_routing_policy",
]
