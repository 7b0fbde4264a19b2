"""Batched policy evaluation: B traces × P policies in one sweep.

Runs the ``StreamExecutor`` window step (no controller, no migrations —
the *static-policy* sweep evaluator) for every (trace, placement) pair at
once. On a card it is one launch of the hand-written ``policy_scan``
kernel (one block a pair walks the windows); on the CPU the kernel's plain
PyTorch version runs the same formulas on (B, P, T) tensors. Both sum in
the executor's order, so the sweep agrees with the executor to ~1e-9 (in
practice to the last bits of its totals). Fields-grouped edges route
through per-key share grids — dense (B, W, N) expansions of each
realization segment's hash→instance map.

Everything runs in float64, as the reference does under x64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.graph import ExecutionGraph
from repro_torch.core.profiles import Cluster
from repro_torch.kernels.policy_scan import ops
from repro_torch.runtime_stream.executor import RuntimeConfig
from repro_torch.runtime_stream.traces import CompiledTrace

__all__ = ["PolicyEvalResult", "evaluate_policies_batch", "scan_operands", "scan_topology"]


@dataclasses.dataclass(frozen=True)
class PolicyEvalResult:
    """Windowed metrics for every (trace b, policy p) pair.

    Shapes: (B, P, W) unless noted. ``sustained`` is the mean throughput
    of the trailing half of the horizon, matching
    ``RuntimeResult.sustained_throughput()``.
    """

    throughput: np.ndarray
    admitted: np.ndarray
    dropped: np.ndarray
    queue_total: np.ndarray
    throttle: np.ndarray
    machine_util_mean: np.ndarray  # (B, P, m) mean over windows
    sustained: np.ndarray          # (B, P)
    window_s: float = 1.0          # trace dt, for the derived latency view

    def latency(self) -> np.ndarray:
        """(B, P, W) Little's-law end-to-end latency estimate per window —
        the same derived view as ``RuntimeResult.latency`` (queued tuples
        over drain rate, capped at the horizon), so batch sweeps and the
        Python executor report one latency definition."""
        horizon = self.throughput.shape[-1] * self.window_s
        with np.errstate(divide="ignore", invalid="ignore"):
            lat = np.where(
                self.queue_total > 0.0,
                self.queue_total / np.maximum(self.throughput, 1e-300),
                0.0,
            )
        return np.minimum(lat, horizon)

    def latency_slo_frac(self, slo_s: float, tail_frac: float = 0.5) -> np.ndarray:
        """(B, P) fraction of trailing-``tail_frac`` windows within the
        latency SLO — mirrors ``RuntimeResult.latency_slo_frac``."""
        W = self.throughput.shape[-1]
        start = int(W * (1.0 - tail_frac))
        return (self.latency()[..., start:] <= slo_s).mean(axis=-1)


def _validate(
    etg: ExecutionGraph,
    cluster: Cluster,
    traces: list[CompiledTrace],
    policies: np.ndarray,
) -> np.ndarray:
    policies = np.asarray(policies, dtype=np.int64)
    T = etg.total_tasks
    if policies.ndim != 2 or policies.shape[1] != T:
        raise ValueError("policies must be (P, T) task->machine rows")
    if policies.size and (
        policies.min() < 0 or policies.max() >= cluster.n_machines
    ):
        # Negative indices would wrap silently through the profile gathers
        # and the one-hot scatter, yielding plausible-looking wrong metrics.
        raise ValueError("policy machine indices must lie in [0, n_machines)")
    if not traces:
        raise ValueError("need at least one trace")
    W = traces[0].n_windows
    want_edges = {g.edge for g in etg.utg.groupings}
    for tr in traces:
        if tr.n_windows != W or tr.window_s != traces[0].window_s:
            raise ValueError("traces must share n_windows and window_s")
        if tr.capacity.shape[1] != cluster.n_machines:
            raise ValueError("trace capacity grid does not match the cluster")
        if {kt.edge for kt in tr.keyed} != want_edges:
            raise ValueError(
                "trace keyed edges do not match the topology's fields "
                "groupings — compile every trace with utg=etg.utg"
            )
    return policies


def _edge_share_grid(tr, edge: tuple[int, int], n_inst: int) -> np.ndarray:
    """(W, n_inst) per-window instance shares of one fields edge (dense
    realization-segment expansion of the hash→instance map)."""
    kt = next(k for k in tr.keyed if k.edge == edge)
    per_seg = np.stack([r.shares(n_inst) for _, r in kt.segments])
    return per_seg[kt.segment_indices(tr.n_windows)]


def scan_topology(etg: ExecutionGraph) -> ops.ScanTopology:
    """The kernel's static view of ``etg``'s topology and instance counts:
    task ranges, spouts, shuffle parents and fields edges."""
    utg = etg.utg
    offsets = etg.component_offsets()
    keyed_edges = tuple(g.edge for g in utg.groupings)
    return ops.ScanTopology(
        offsets=tuple(int(x) for x in offsets),
        alpha=tuple(float(a) for a in utg.alpha),
        sources=tuple(i in set(utg.sources) for i in range(utg.n_components)),
        parents=tuple(
            tuple(p for p in utg.parents(i) if (p, i) not in keyed_edges)
            for i in range(utg.n_components)
        ),
        keyed=tuple((p, int(offsets[i]), int(offsets[i + 1])) for p, i in keyed_edges),
    )


def evaluate_policies_batch(
    etg: ExecutionGraph,
    cluster: Cluster,
    traces: list[CompiledTrace],
    policies: np.ndarray,
    config: RuntimeConfig | None = None,
    device: str | torch.device = "cuda",
    external_load: np.ndarray | None = None,
) -> PolicyEvalResult:
    """Run every trace against every static placement in one sweep.

    Args:
      etg: supplies the topology and instance counts (its own assignment
        is ignored — placements come in as ``policies`` rows, like
        ``simulate_batch``).
      cluster: the cluster; each trace's capacity grid modulates it.
      traces: B compiled traces sharing one horizon (W windows, same dt).
      policies: (P, T) machine index per task per candidate placement.
      config: event-loop constants (must match the Python executor's for
        parity comparisons).
      device: ``"cuda"`` (default: one launch of the ``policy_scan``
        kernel; raises without a card) or ``"cpu"`` (its plain PyTorch
        version).
      external_load: optional (W, m) or (m,) load held by co-tenants of
        the shared machines, subtracted (clipped at zero) from every
        trace's capacity grid before evaluation — the tenant dimension of
        the batch evaluator, matching ``StreamExecutor(background_load=)``.
    """
    dev = resolve_device(device)
    config = config or RuntimeConfig()
    if external_load is not None and traces:
        bg = np.asarray(external_load, dtype=np.float64)
        shape = traces[0].capacity.shape
        if bg.ndim == 1:
            bg = np.broadcast_to(bg, shape)
        if bg.shape != shape:
            raise ValueError(
                f"external_load must be (m,) or match the (W, m) capacity grid {shape}"
            )
        traces = [
            dataclasses.replace(tr, capacity=np.clip(tr.capacity - bg, 0.0, None))
            for tr in traces
        ]
    policies = _validate(etg, cluster, traces, policies)
    operands, topo, cfg = scan_operands(etg, cluster, traces, policies, config, dev)
    out = ops.policy_scan(*operands, topo, cfg)
    host = {k: v.cpu().numpy() for k, v in out._asdict().items()}
    start = traces[0].n_windows // 2  # == RuntimeResult.sustained_throughput's tail split
    return PolicyEvalResult(
        sustained=host["throughput"][:, :, start:].mean(axis=2),
        window_s=traces[0].window_s,
        **host,
    )


def scan_operands(
    etg: ExecutionGraph,
    cluster: Cluster,
    traces: list[CompiledTrace],
    policies: np.ndarray,
    config: RuntimeConfig,
    device: torch.device,
) -> tuple[tuple[torch.Tensor, ...], ops.ScanTopology, ops.ScanConfig]:
    """The ``policy_scan`` operands of a validated sweep on ``device``:
    (rates, capacity, task_machine, e, met, shares), the topology and the
    loop constants."""
    comp = etg.task_component()
    ttypes = etg.utg.component_types[comp]
    mtypes = cluster.machine_types[policies]                 # (P, T)
    e = cluster.profile.e[ttypes[None, :], mtypes]           # (P, T)
    met = cluster.profile.met[ttypes[None, :], mtypes]
    rates = np.stack([tr.rates for tr in traces])            # (B, W)
    caps = np.stack([tr.capacity for tr in traces])          # (B, W, m)
    grids = [
        np.stack([_edge_share_grid(tr, (p, i), int(etg.n_instances[i])) for tr in traces])
        for p, i in (g.edge for g in etg.utg.groupings)
    ]                                                        # each (B, W, N)
    shares = (np.concatenate(grids, axis=2) if grids
              else np.zeros((len(traces), traces[0].n_windows, 0)))

    def tensor(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(device)

    cfg = ops.ScanConfig(
        window_s=float(traces[0].window_s), max_queue=config.max_queue,
        bp_high=config.bp_high, bp_low=config.bp_low, throttle_down=config.throttle_down,
        throttle_up=config.throttle_up, throttle_min=config.throttle_min,
    )
    operands = (tensor(rates, np.float64), tensor(caps, np.float64), tensor(policies, np.int32),
                tensor(e, np.float64), tensor(met, np.float64), tensor(shares, np.float64))
    return operands, scan_topology(etg), cfg
