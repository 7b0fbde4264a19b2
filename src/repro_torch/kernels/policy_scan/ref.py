"""Plain PyTorch version of the policy-sweep kernel.

The streaming executor's window step with no controller and no migrations
(``runtime_stream.executor.StreamExecutor._run``), run for B traces x P
static placements at once on (B, P, T) tensors: a Python loop over the W
windows, per-machine sums by ``scatter_add_``, per-machine reads by
``gather``. The formulas and their order are the executor's. Every sum over
tasks adds in task order on the CPU (``scatter_add_`` and ``cumsum`` there
run in index order, as ``np.bincount`` does), which is the order of
``csrc/policy_scan.cu``; on a card ``scatter_add_`` uses atomics and the
order is free.

A task id outside [0, m) matches no machine: it never serves and adds to no
machine's load (the kernel's rule too).

The CPU path of ``ops.policy_scan`` runs it; ``chip_smoke.py`` holds the
CUDA kernel against it on the card.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

__all__ = ["ScanConfig", "ScanOutput", "ScanTopology", "policy_scan_ref"]


@dataclasses.dataclass(frozen=True)
class ScanTopology:
    """Static structure of the window step.

    Attributes:
      offsets: (n + 1,) task range ``[offsets[c], offsets[c + 1])`` of each
        component; tasks are grouped by component in component order.
      alpha: (n,) output ratio of each component.
      sources: (n,) whether a component is a spout (fed the admitted rate).
      parents: per component, its shuffle-grouped parents in edge order.
      keyed: per fields-grouped edge in declaration order, (parent, lo, hi):
        the parent and the destination's task range. Its shares are columns
        ``[s, s + hi - lo)`` of the shares grid, the edges laid end to end.
    """

    offsets: tuple[int, ...]
    alpha: tuple[float, ...]
    sources: tuple[bool, ...]
    parents: tuple[tuple[int, ...], ...]
    keyed: tuple[tuple[int, int, int], ...] = ()

    def __post_init__(self) -> None:
        n = len(self.alpha)
        if len(self.offsets) != n + 1 or len(self.sources) != n or len(self.parents) != n:
            raise ValueError("offsets, alpha, sources and parents must describe the same "
                             "components")
        if any(hi < lo for lo, hi in zip(self.offsets[:-1], self.offsets[1:])):
            raise ValueError(f"offsets {self.offsets} must not decrease")
        for par, lo, hi in self.keyed:
            if not (0 <= par < n and self.offsets[0] <= lo <= hi <= self.offsets[-1]):
                raise ValueError(f"keyed edge {(par, lo, hi)} is out of range")
        if any(not 0 <= q < n for ps in self.parents for q in ps):
            raise ValueError("a parent is out of range")

    @property
    def n_components(self) -> int:
        return len(self.alpha)

    @property
    def n_tasks(self) -> int:
        return self.offsets[-1]

    @property
    def counts(self) -> tuple[int, ...]:
        """Instances of each component."""
        return tuple(hi - lo for lo, hi in zip(self.offsets[:-1], self.offsets[1:]))

    @property
    def n_shares(self) -> int:
        return sum(hi - lo for _, lo, hi in self.keyed)


@dataclasses.dataclass(frozen=True)
class ScanConfig:
    """Event-loop constants (``RuntimeConfig``'s, with the window length)."""

    window_s: float = 1.0
    max_queue: float = 500.0
    bp_high: float = 0.5
    bp_low: float = 0.1
    throttle_down: float = 0.5
    throttle_up: float = 1.25
    throttle_min: float = 0.05


class ScanOutput(NamedTuple):
    """(B, P, W) per-window metrics and the (B, P, m) window-mean
    utilization of every (trace, placement) pair."""

    throughput: torch.Tensor
    admitted: torch.Tensor
    dropped: torch.Tensor
    queue_total: torch.Tensor
    throttle: torch.Tensor
    machine_util_mean: torch.Tensor


def _ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, adding in index order on the CPU."""
    if x.shape[-1] == 0:
        return x.new_zeros(x.shape[:-1])
    return x.cumsum(-1)[..., -1]


def policy_scan_ref(
    rates: torch.Tensor,         # (B, W) offered rate per window
    capacity: torch.Tensor,      # (B, W, m) machine capacity per window
    task_machine: torch.Tensor,  # (P, T) int machine per task
    e: torch.Tensor,             # (P, T) float64 eq. 5 slope per task
    met: torch.Tensor,           # (P, T) float64 eq. 5 fixed cost per task
    shares: torch.Tensor,        # (B, W, S) keyed edges' instance shares
    topo: ScanTopology,
    cfg: ScanConfig,
) -> ScanOutput:
    dev, f64 = rates.device, torch.float64
    B, W = rates.shape
    P, T = task_machine.shape
    m = capacity.shape[2]
    n = topo.n_components
    dt = float(cfg.window_s)
    off = topo.offsets
    counts = torch.tensor(topo.counts, device=dev)
    comp = torch.repeat_interleave(torch.arange(n, device=dev), counts)  # (T,)
    n_task = counts.to(f64)[comp]
    alpha = [float(a) for a in topo.alpha]
    valid = (task_machine >= 0) & (task_machine < m)                      # (P, T)
    tm = torch.where(valid, task_machine, 0).long()
    tm_b = tm[None].expand(B, P, T)
    valid_f = valid.to(f64)[None]                                         # (1, P, T)
    soff = [0]
    for _, lo, hi in topo.keyed:
        soff.append(soff[-1] + hi - lo)

    # Fixed per-machine load: every task is active (no migrations).
    met_w = torch.zeros((P, m), dtype=f64, device=dev).scatter_add_(1, tm, met * valid_f[0])
    backlog = torch.zeros((B, P, T), dtype=f64, device=dev)
    prev_out = torch.zeros((B, P, n), dtype=f64, device=dev)
    throttle = torch.ones((B, P), dtype=f64, device=dev)
    util_sum = torch.zeros((B, P, m), dtype=f64, device=dev)
    logs = {k: torch.empty((B, P, W), dtype=f64, device=dev)
            for k in ("throughput", "admitted", "dropped", "queue_total", "throttle")}
    for t in range(W):
        cap = capacity[:, t, :]                                           # (B, m)
        r_adm = rates[:, t, None] * throttle                              # (B, P)
        # 1. Arrivals: spouts at the admitted rate, shuffle parents' last
        # output split evenly, then each fields edge at its shares.
        arr = []
        for c in range(n):
            if topo.sources[c]:
                arr.append(r_adm)
            else:
                a = torch.zeros_like(r_adm)
                for p in topo.parents[c]:
                    a = a + alpha[p] * prev_out[:, :, p]
                arr.append(a)
        arr_task = torch.stack(arr, dim=2).index_select(2, comp) / n_task
        for k, (p, lo, hi) in enumerate(topo.keyed):
            contrib = alpha[p] * prev_out[:, :, p]                         # (B, P)
            arr_task[:, :, lo:hi] += contrib[:, :, None] * shares[:, t, None, soff[k]:soff[k + 1]]
        backlog = backlog + arr_task * dt
        over = (backlog - cfg.max_queue).clamp_min(0.0)
        backlog = backlog - over
        # 2. Service under proportional fair machine throttling.
        desired = backlog / dt
        var_w = torch.zeros((B, P, m), dtype=f64, device=dev).scatter_add_(
            2, tm_b, e * desired * valid_f)
        head = (cap[:, None, :] - met_w).clamp_min(0.0)
        s = torch.where(var_w > head, head / var_w.clamp_min(1e-300), 1.0)
        processed = desired * (s.gather(2, tm_b) * valid_f)
        backlog = (backlog - processed * dt).clamp_min(0.0)
        alive = (cap > 0.0).to(f64)[:, None, :].expand(B, P, m).gather(2, tm_b) * valid_f
        tcu = e * processed + met * alive
        prev_out = torch.stack([_ordered_sum(processed[:, :, off[c]:off[c + 1]])
                                for c in range(n)], dim=2)
        # 3. Metrics, then the spout throttle for the next window (logged
        # before it updates).
        util_sum = util_sum + torch.zeros_like(util_sum).scatter_add_(2, tm_b, tcu)
        logs["throughput"][:, :, t] = _ordered_sum(processed)
        logs["admitted"][:, :, t] = r_adm
        logs["dropped"][:, :, t] = _ordered_sum(over) / dt
        logs["queue_total"][:, :, t] = _ordered_sum(backlog)
        logs["throttle"][:, :, t] = throttle
        q_frac = backlog.amax(dim=2) / cfg.max_queue
        throttle = torch.where(
            q_frac > cfg.bp_high,
            (throttle * cfg.throttle_down).clamp_min(cfg.throttle_min),
            torch.where(q_frac < cfg.bp_low, (throttle * cfg.throttle_up).clamp_max(1.0),
                        throttle),
        )
    return ScanOutput(machine_util_mean=util_sum / W, **logs)
