"""Heterogeneous serving planner: the paper's algorithm as a first-class
framework feature.

The port of ``repro.sched.planner``. ``plan(cfg, fleet)`` builds the stage
graph (``repro_torch.sched.stage_model``), runs FirstAssignment +
MaximizeThroughput (+ the local-search refinement, its candidate sweeps on
``device``) over the fleet's device groups, and returns a ParallelismPlan:
how many replicas of each pipeline stage run on which pool, and the max
stable token admission rate — the LM-serving incarnation of the paper's
execution topology graph.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import max_stable_rate, round_robin_schedule, schedule
from repro_torch.core.refine import refine
from repro_torch.models.config import ModelConfig
from repro_torch.sched.fleet import Fleet
from repro_torch.sched.stage_model import build_stage_model, fleet_cluster

__all__ = ["ParallelismPlan", "plan"]

# ``refine`` runs only on plans this small, as in the reference.
REFINE_MAX_TASKS = 64
REFINE_MAX_GROUPS = 64


@dataclasses.dataclass
class ParallelismPlan:
    arch: str
    n_stages: int
    # replicas[stage][pool] = number of stage replicas hosted by that pool
    replicas: np.ndarray
    assignment: list[np.ndarray]      # per-stage group indices
    tokens_per_s: float               # max stable admission rate
    predicted_throughput: float       # paper objective (sum of stage rates)
    baseline_tokens_per_s: float      # round-robin placement baseline
    iterations: int

    def summary(self) -> str:
        lines = [
            f"plan[{self.arch}] stages={self.n_stages} "
            f"admission={self.tokens_per_s:,.0f} tok/s "
            f"(round-robin baseline {self.baseline_tokens_per_s:,.0f} tok/s)"
        ]
        for s in range(self.replicas.shape[0]):
            pools = ", ".join(
                f"pool{j}x{int(c)}" for j, c in enumerate(self.replicas[s]) if c
            )
            lines.append(f"  stage{s}: {pools}")
        return "\n".join(lines)


def plan(
    cfg: ModelConfig,
    fleet: Fleet,
    n_stages: int = 4,
    r0: float = 1.0,
    use_refine: bool = True,
    device: str | torch.device = "cuda",
) -> ParallelismPlan:
    """Plan ``cfg``'s pipeline stages over ``fleet``. ``refine`` (when the
    plan has at most 64 tasks over at most 64 groups) scores its candidates
    on ``device``; a ``"cuda"`` request without a card raises even where
    the gate skips ``refine``."""
    dev = resolve_device(device)
    sm = build_stage_model(cfg, fleet, n_stages=n_stages)
    cluster = fleet_cluster(fleet, sm)

    sched = schedule(sm.utg, cluster, r0=r0, rate_epsilon=max(r0, 1.0))
    etg = sched.etg
    if (use_refine and etg.total_tasks <= REFINE_MAX_TASKS
            and cluster.n_machines <= REFINE_MAX_GROUPS):
        etg = refine(etg, cluster, device=dev).etg
    rate, thpt = max_stable_rate(etg, cluster)

    rr = round_robin_schedule(sm.utg, cluster, etg.n_instances)
    rr_rate, _ = max_stable_rate(rr, cluster)

    pool_of = fleet.pool_of_group()
    n_pools = len(fleet.pools)
    reps = np.zeros((sm.utg.n_components, n_pools), dtype=np.int64)
    for comp in range(sm.utg.n_components):
        for g in etg.assignment[comp]:
            reps[comp, pool_of[g]] += 1

    return ParallelismPlan(
        arch=cfg.name,
        n_stages=n_stages,
        replicas=reps[1:],           # drop the ingress component
        assignment=etg.assignment[1:],
        tokens_per_s=float(rate),
        predicted_throughput=float(thpt),
        baseline_tokens_per_s=float(rr_rate),
        iterations=sched.iterations,
    )
