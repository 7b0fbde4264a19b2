"""The LM-serving planner: the paper's scheduler over a GPU fleet.

The port of ``repro.sched``: ``fleet`` (chips, pools, fleets), ``stage_model``
(an architecture as a chain of pipeline stages costed on each pool),
``planner`` (``plan``: stage replicas per pool and the admission rate) and
``elastic`` (``ElasticController``: re-planning on failure and restore).
"""

from repro_torch.sched.elastic import ElasticController
from repro_torch.sched.fleet import (
    A100_SXM,
    H100_SXM,
    L4,
    ChipSpec,
    DevicePool,
    Fleet,
    h100_node_fleet,
)
from repro_torch.sched.planner import ParallelismPlan, plan
from repro_torch.sched.stage_model import StageModel, build_stage_model, fleet_cluster

__all__ = [
    "A100_SXM",
    "H100_SXM",
    "L4",
    "ChipSpec",
    "DevicePool",
    "ElasticController",
    "Fleet",
    "ParallelismPlan",
    "StageModel",
    "build_stage_model",
    "fleet_cluster",
    "h100_node_fleet",
    "plan",
]
