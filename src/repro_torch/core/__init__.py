"""Core: the paper's scheduling algorithms, ported to PyTorch.

Same public names as ``repro.core``; the batched entry points
(``max_stable_rate_batch``, ``ScheduleState.score_task_machine_batch``,
``refine``, ``optimal_schedule``, ``simulate_batch``) take ``device=`` and
default to ``"cuda"``. ``convert`` builds these objects from the
reference's.

Public API:
  graphs:      UserGraph, ExecutionGraph, linear/diamond/star topologies
  profiling:   Profile, Cluster, paper_profile, paper_cluster
  prediction:  predict (eq. 5/6)
  simulator:   simulate, simulate_batch, measured_tcu (§6.3 ground truth)
  schedulers:  schedule (Alg. 1+2), round_robin_schedule, optimal_schedule,
               refine (beyond-paper hill climb)
  metrics:     weighted_utilization, prediction_accuracy, gain_ratio
"""

from repro_torch.core.cost_model import (
    Prediction,
    SkewModel,
    component_rates,
    instance_rates,
    max_stable_rate,
    max_stable_rate_batch,
    network_unit_load,
    predict,
    resource_operands,
)
from repro_torch.core.first_assignment import first_assignment
from repro_torch.core.graph import (
    ExecutionGraph,
    FieldsGrouping,
    UserGraph,
    diamond_topology,
    keyed_rolling_count_topology,
    linear_topology,
    rolling_count_topology,
    star_topology,
    unique_visitor_topology,
    wide_fanout_topology,
)
from repro_torch.core.maximize_throughput import Schedule, maximize_throughput, schedule
from repro_torch.core.metrics import (
    fairness_levels,
    gain_ratio,
    jain_index,
    per_machine_utilization,
    prediction_accuracy,
    weighted_utilization,
)
from repro_torch.core.optimal import OptimalResult, optimal_schedule, placement_score
from repro_torch.core.profiles import (
    Cluster,
    Profile,
    paper_cluster,
    paper_profile,
    rack_distance_matrix,
)
from repro_torch.core.refine import RefineResult, refine
from repro_torch.core.round_robin import round_robin_schedule
from repro_torch.core.schedule_state import ScheduleState
from repro_torch.core.simulator import SimResult, measured_tcu, simulate, simulate_batch

__all__ = [
    "Prediction",
    "component_rates",
    "instance_rates",
    "predict",
    "first_assignment",
    "ExecutionGraph",
    "FieldsGrouping",
    "SkewModel",
    "UserGraph",
    "diamond_topology",
    "keyed_rolling_count_topology",
    "linear_topology",
    "rolling_count_topology",
    "star_topology",
    "unique_visitor_topology",
    "wide_fanout_topology",
    "Schedule",
    "ScheduleState",
    "maximize_throughput",
    "schedule",
    "fairness_levels",
    "gain_ratio",
    "jain_index",
    "per_machine_utilization",
    "prediction_accuracy",
    "weighted_utilization",
    "OptimalResult",
    "optimal_schedule",
    "placement_score",
    "RefineResult",
    "refine",
    "max_stable_rate",
    "max_stable_rate_batch",
    "network_unit_load",
    "resource_operands",
    "Cluster",
    "Profile",
    "paper_cluster",
    "paper_profile",
    "rack_distance_matrix",
    "round_robin_schedule",
    "SimResult",
    "measured_tcu",
    "simulate",
    "simulate_batch",
]
