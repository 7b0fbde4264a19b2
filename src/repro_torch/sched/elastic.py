"""Elastic re-planning on fleet changes — the paper's "by any change in the
cluster state, this algorithm can be used to recalculate the new number of
instances and their suitable assignment", wired to the runtime.

The port of ``repro.sched.elastic``. ``ElasticController`` tracks the
healthy group set; ``fail()`` / ``restore()`` mutate it and re-run the
planner (its ``refine`` on ``device``), producing a new ParallelismPlan
and a new admission rate. The serve example drives it.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.sched.fleet import DevicePool, Fleet
from repro_torch.sched.planner import ParallelismPlan, plan

__all__ = ["ElasticController"]


@dataclasses.dataclass
class _PoolState:
    pool: DevicePool
    healthy: int


class ElasticController:
    def __init__(self, cfg: ModelConfig, fleet: Fleet, n_stages: int = 4,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self._pools = [_PoolState(p, p.count) for p in fleet.pools]
        self.n_stages = n_stages
        self.device = device
        self.history: list[tuple[str, ParallelismPlan]] = []
        self.current = self._replan("initial")

    def _fleet(self) -> Fleet:
        return Fleet(pools=tuple(
            dataclasses.replace(ps.pool, count=ps.healthy)
            for ps in self._pools if ps.healthy > 0
        ))

    def _replan(self, reason: str) -> ParallelismPlan:
        p = plan(self.cfg, self._fleet(), n_stages=self.n_stages, device=self.device)
        self.history.append((reason, p))
        return p

    def fail(self, pool_idx: int, count: int = 1) -> ParallelismPlan:
        """Mark ``count`` groups of a pool failed; re-plan the remainder."""
        ps = self._pools[pool_idx]
        ps.healthy = max(ps.healthy - count, 0)
        self.current = self._replan(f"fail pool{pool_idx} x{count}")
        return self.current

    def restore(self, pool_idx: int, count: int = 1) -> ParallelismPlan:
        ps = self._pools[pool_idx]
        ps.healthy = min(ps.healthy + count, ps.pool.count)
        self.current = self._replan(f"restore pool{pool_idx} x{count}")
        return self.current

    @property
    def admission_rate(self) -> float:
        return self.current.tokens_per_s
