"""Rate-based cluster simulator — the paper's §6.3 simulator, batched on torch.

Given an ETG, a cluster and an offered topology input rate, compute the
*measured* steady state: per-task processing rates under machine saturation
and back-pressure, per-machine utilization, and overall throughput.

Saturation model
----------------
A machine w hosting tasks with offered variable load ``sum_i e_i * IR_i``
and fixed overhead ``sum_i MET_i`` saturates when total demand exceeds its
capacity. Under overload the machine applies proportional fair throttling:
every hosted task processes at ``s_w * IR_i`` with

    s_w = clip((capacity_w - sum MET) / sum(e_i * IR_i), 0, 1).

Throttled output back-pressures downstream components, so the steady state
is a fixed point, iterated to convergence with a hard cap
(``sim_torch.simulate_batch_torch``).

The reference's CPU-calibrated ``"auto"`` backend thresholds are not
carried over: the batched entry points take an explicit ``device``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.graph import ExecutionGraph
from repro_torch.core.profiles import Cluster
from repro_torch.obs.trace import record_dispatch

__all__ = [
    "SimResult",
    "BatchSimResult",
    "simulate",
    "simulate_batch",
    "measured_tcu",
    "resolve_closed_form_device",
]


@dataclasses.dataclass(frozen=True)
class SimResult:
    """Steady state of the simulated cluster.

    Attributes:
      ir: (T,) offered per-task input rate (post-back-pressure).
      pr: (T,) processing rate actually achieved per task.
      tcu: (T,) occupied CPU per task at the steady state.
      machine_util: (m,) per-machine utilization.
      throughput: overall topology throughput = sum of task processing
        rates (the paper's throughput definition, eq. 2).
    """

    ir: np.ndarray
    pr: np.ndarray
    tcu: np.ndarray
    machine_util: np.ndarray
    throughput: float


@dataclasses.dataclass(frozen=True)
class BatchSimResult:
    ir: np.ndarray            # (B, T)
    pr: np.ndarray            # (B, T)
    tcu: np.ndarray           # (B, T)
    machine_util: np.ndarray  # (B, m)
    throughput: np.ndarray    # (B,)

    def row(self, i: int) -> SimResult:
        """Single candidate row as a ``SimResult``."""
        return SimResult(
            ir=self.ir[i],
            pr=self.pr[i],
            tcu=self.tcu[i],
            machine_util=self.machine_util[i],
            throughput=float(self.throughput[i]),
        )


def resolve_closed_form_device(
    device: str | torch.device,
    elements: int | None = None,
    regime: str = "shared",
    n_machines: int | None = None,
    site: str | None = None,
) -> torch.device:
    """Validate the device of a closed-form sweep and record the decision.

    Shared by ``cost_model.max_stable_rate_batch`` and
    ``ScheduleState.score_task_machine_batch``. ``"cuda"`` without a card
    raises (no silent CPU fallback). ``regime`` (``"shared"``,
    ``"per_row"`` or ``"skew"``), ``elements`` (B*T), ``n_machines`` and
    ``site`` only label the record in the observability dispatch log.
    """
    from repro_torch import resolve_device

    dev = resolve_device(device)
    record_dispatch(str(device), dev.type, regime, elements, n_machines, site)
    return dev


def simulate(
    etg: ExecutionGraph,
    cluster: Cluster,
    r0: float,
    device: str | torch.device = "cuda",
) -> SimResult:
    """Single-placement steady state (thin wrapper over the batched core)."""
    machine = etg.task_machine()[None, :]
    return simulate_batch(etg, cluster, machine, r0, device=device).row(0)


def simulate_batch(
    etg: ExecutionGraph,
    cluster: Cluster,
    task_machine: np.ndarray,
    r0,
    device: str | torch.device = "cuda",
) -> BatchSimResult:
    """Evaluate B placements (same instance counts) in one batched fixed point.

    Args:
      etg: supplies the UTG and instance counts (its own assignment ignored).
      task_machine: (B, T) machine index per task per candidate.
      r0: offered topology input rate at each spout — a scalar applied to
        every candidate, or a (B,) vector with one rate per candidate row.
      device: ``"cuda"`` (default; raises without a card) or ``"cpu"``.
        Agrees with the reference's NumPy loop to 1e-9.
    """
    from repro_torch import resolve_device

    dev = resolve_device(device)
    comp = etg.task_component()
    task_machine = np.asarray(task_machine, dtype=np.int64)
    if task_machine.ndim != 2 or task_machine.shape[1] != comp.shape[0]:
        raise ValueError("task_machine must be (B, T)")
    B, T = task_machine.shape
    m = cluster.n_machines
    r0 = np.asarray(r0, dtype=np.float64)
    if r0.ndim not in (0, 1) or (r0.ndim == 1 and r0.shape != (B,)):
        raise ValueError("r0 must be a scalar or a (B,) vector")
    if B == 0:
        # Empty batch: the fixed point's convergence reduction is undefined
        # over zero rows; return correctly-shaped empties instead.
        empty = np.zeros((0, T), dtype=np.float64)
        return BatchSimResult(
            ir=empty,
            pr=empty.copy(),
            tcu=empty.copy(),
            machine_util=np.zeros((0, m), dtype=np.float64),
            throughput=np.zeros(0, dtype=np.float64),
        )
    from repro_torch.core.sim_torch import simulate_batch_torch

    r0_b = np.broadcast_to(r0, (B,)).copy()
    ir, pr, tcu, util, thpt = simulate_batch_torch(etg, cluster, task_machine, r0_b, dev)
    return BatchSimResult(ir=ir, pr=pr, tcu=tcu, machine_util=util, throughput=thpt)


def measured_tcu(
    etg: ExecutionGraph,
    cluster: Cluster,
    r0: float,
    seed: int = 0,
    noise_scale: float = 0.035,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """'Measured' per-task CPU utilization with the paper's noise profile.

    §6.2: measurement variance is low when the CPU is lightly or heavily
    loaded and highest at moderate load. We model the measurement error as
    zero-mean Gaussian with std ``noise_scale * 100 * 4u(1-u)`` where u is
    the machine's utilization fraction — a parabola peaking at u=0.5 —
    truncated so the max |error| stays below the paper's observed 8 points.
    The noise comes from ``numpy.random.default_rng(seed)``, as in the
    reference, so both give the same draws.
    """
    sim = simulate(etg, cluster, r0, device=device)
    machine = etg.task_machine()
    u = np.clip(sim.machine_util[machine] / cluster.capacity[machine], 0.0, 1.0)
    std = noise_scale * 100.0 * 4.0 * u * (1.0 - u)
    rng = np.random.default_rng(seed)
    noise = np.clip(rng.normal(0.0, 1.0, size=std.shape) * std, -7.9, 7.9)
    return np.clip(sim.tcu + noise, 0.0, None)
