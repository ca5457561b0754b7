"""Elastic autoscaler plane: utilization in, resize decisions out (port
of ``edl_tpu.scaler``).

Torch-free by design, like the coord/ plane: the policies, simulator and
controller import nothing heavier than the coordination store, so
``python -m edl_tpu_torch.scaler`` runs on a scheduler node with no
accelerator stack.

- `scaler.policy`: `ScalingPolicy` protocol, `ThroughputPolicy`
  (marginal-gain autoscaling with hysteresis and downtime amortization),
  `FairSharePolicy` (budget water-fill across jobs).
- `scaler.controller`: leader-elected Collector -> policy -> JobServer
  loop with a store and file decision journal and ``--dry-run``.
- `scaler.simulator`: deterministic `SimCluster` and `SimServingPool`
  (synthetic curves and traces, seeded noise, virtual time).
- `scaler.serving`: `ServingPolicy` and `TeacherPoolActuator`, the
  teacher pool's SLO-driven grow and drained shrink.
"""

from edl_tpu_torch.scaler.policy import (FairSharePolicy, JobView,
                                         Proposal, ScalingPolicy,
                                         ThroughputPolicy)
from edl_tpu_torch.scaler.controller import (DecisionJournal, ScalerConfig,
                                             ScalerController)

__all__ = ["FairSharePolicy", "JobView", "Proposal", "ScalingPolicy",
           "ThroughputPolicy", "DecisionJournal", "ScalerConfig",
           "ScalerController"]
