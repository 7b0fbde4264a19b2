"""Torch fixed point of the batched back-pressure simulator (§6.3).

Counterpart of ``repro.core.sim_jax``'s ``_compiled_kernel``: the same
damped iteration, topo-order propagation and termination rule as the NumPy
loop in ``simulator.py``, on torch tensors on an explicit device. The task
dimension collapses before the loop: instances of one component on one
machine are interchangeable, so the loop state is the (B, n, m) count
tensor and each step is two contractions plus the O(n) topo recurrence.

The reference's other twin, the closed-form scorer ``_msr_kernel`` (and the
Pallas route ``_use_pallas_scoring`` chose), has one path in the port:
``cost_model.closed_form_rates`` -> ``kernels.sched_scoring.ops``.

Sums here run in another order than the NumPy loop's per-task
``np.add.at``, so results agree with it to ~1e-15 (the contract is 1e-9);
no reduction uses atomics, so reruns are bit-identical.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import ExecutionGraph
from repro_torch.core.profiles import Cluster

__all__ = ["simulate_batch_torch"]

_MAX_ITERS = 200
_TOL = 1e-10


def simulate_batch_torch(
    etg: ExecutionGraph,
    cluster: Cluster,
    task_machine: np.ndarray,
    r0: np.ndarray,
    device: torch.device,
) -> tuple[np.ndarray, ...]:
    """(ir, pr, tcu, machine_util, throughput) NumPy arrays for B >= 1 rows.

    ``task_machine`` is (B, T) and ``r0`` a (B,) per-row offered rate.
    """
    utg = etg.utg
    f64 = torch.float64
    n = utg.n_components
    m = cluster.n_machines
    comp_np = etg.task_component()
    ttypes = utg.component_types
    tm = torch.as_tensor(np.asarray(task_machine, dtype=np.int64), device=device)
    B, T = tm.shape
    comp = torch.as_tensor(comp_np, device=device)
    e_cm = torch.as_tensor(cluster.profile.e[ttypes][:, cluster.machine_types], device=device)
    met_cm = torch.as_tensor(cluster.profile.met[ttypes][:, cluster.machine_types], device=device)
    capacity = torch.as_tensor(cluster.capacity, device=device)
    n_inst = [float(k) for k in etg.n_instances]
    r0_b = torch.as_tensor(np.asarray(r0, dtype=np.float64), device=device)

    # Instance counts per (row, component, machine): sums of ones, exact.
    counts = torch.zeros((B, n * m), dtype=f64, device=device)
    counts.scatter_add_(
        1, comp[None, :] * m + tm, torch.ones((B, T), dtype=f64, device=device)
    )
    counts = counts.view(B, n, m)
    ew = counts * e_cm[None, :, :]                    # variable-load weights
    met_load = (counts * met_cm[None, :, :]).sum(dim=1)
    head = (capacity[None, :] - met_load).clamp_min(0.0)

    topo = utg.topo_order()
    sources = set(utg.sources)
    parents = [utg.parents(i) for i in range(n)]
    alpha = utg.alpha

    s = torch.ones((B, m), dtype=f64, device=device)
    per_inst = torch.zeros((B, n), dtype=f64, device=device)
    for _ in range(_MAX_ITERS):
        per: list = [None] * n
        pr: list = [None] * n
        for i in topo:
            if i in sources:
                cir_i = r0_b
            else:
                cir_i = torch.zeros((B,), dtype=f64, device=device)
                for p in parents[i]:
                    cir_i = cir_i + float(alpha[p]) * pr[p]
            per[i] = cir_i / n_inst[i]
            pr[i] = per[i] * (counts[:, i, :] * s).sum(dim=1)
        per_inst = torch.stack(per, dim=1)            # (B, n)
        var_load = (per_inst[:, :, None] * ew).sum(dim=1)
        s_new = torch.where(
            var_load > head, head / var_load.clamp_min(1e-300), torch.ones_like(s)
        )
        converged = bool((s_new - s).abs().max() < _TOL)
        s = s_new
        if converged:
            break

    # Per-task readout, once: ``per_inst`` from the last propagation
    # (previous s), ``s`` the final factor — the NumPy loop's exit state.
    ir = per_inst[:, comp]                            # (B, T)
    e = e_cm[comp[None, :], tm]
    met = met_cm[comp[None, :], tm]
    pr_task = ir * torch.gather(s, 1, tm)
    tcu = e * pr_task + met
    # Per-machine utilization from the count tensor (every instance of a
    # component on a machine carries the same TCU): no float atomics.
    tcu_cm = e_cm[None, :, :] * (per_inst[:, :, None] * s[:, None, :]) + met_cm[None, :, :]
    util = (counts * tcu_cm).sum(dim=1)
    thpt = pr_task.sum(dim=1)
    return tuple(x.cpu().numpy() for x in (ir, pr_task, tcu, util, thpt))
