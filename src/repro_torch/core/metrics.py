"""Evaluation metrics: overall throughput, weighted utilization (eq. 7/8),
prediction accuracy (Fig. 6), throughput/utilization difference ratio
(Table 5).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.graph import ExecutionGraph
from repro_torch.core.profiles import Cluster
from repro_torch.core.simulator import SimResult

__all__ = [
    "per_machine_utilization",
    "weighted_utilization",
    "prediction_accuracy",
    "gain_ratio",
    "fairness_levels",
    "jain_index",
]


def per_machine_utilization(
    machine: np.ndarray, tcu: np.ndarray, n_machines: int
) -> np.ndarray:
    """(m,) utilization per machine: sum of hosted tasks' TCU.

    The one accumulation shared by eq. 7's weighting, the simulator readout
    and the streaming runtime's windowed metrics, so "machine utilization"
    means the same reduction everywhere. ``np.bincount`` accumulates
    sequentially in input order exactly like ``np.add.at`` (the streaming
    fingerprint goldens pin the bit-identity) but without the per-element
    ufunc dispatch — this runs three times per executor window.
    """
    return np.bincount(
        machine, weights=np.asarray(tcu, dtype=np.float64), minlength=n_machines
    )


def weighted_utilization(
    etg: ExecutionGraph, cluster: Cluster, sim: SimResult
) -> float:
    """Overall utilization U (eq. 7) with machine-type weights x_i (eq. 8).

    Weights favor machine types with more processing capability: for each
    *component type* c present in the topology and machine type t,
    ``x_{tc} = (1/e_{ct}) / sum_k (1/e_{ck})``; a machine type's weight is the
    sum over component types, and U is the weighted mean of the per-type
    average utilizations (normalized so weights sum to 1).
    """
    # Component types present (C <= n in the paper's notation); skip spouts.
    ctypes = np.unique(etg.utg.component_types)
    ctypes = ctypes[ctypes != 0] if (ctypes == 0).any() and len(ctypes) > 1 else ctypes
    mtypes = np.unique(cluster.machine_types)

    e = cluster.profile.e[np.ix_(ctypes, mtypes)]  # (C, T)
    inv = 1.0 / e
    x_ct = inv / inv.sum(axis=1, keepdims=True)    # eq. 8 per component type
    x_t = x_ct.sum(axis=0)                         # eq. 8 summed over C
    x_t = x_t / x_t.sum()

    util = per_machine_utilization(etg.task_machine(), sim.tcu, cluster.n_machines)
    u_bar = np.array(
        [util[cluster.machine_types == t].mean() for t in mtypes]
    )
    return float((x_t * u_bar).sum())              # eq. 7


def prediction_accuracy(predicted: np.ndarray, measured: np.ndarray) -> float:
    """Accuracy as 100 - mean absolute error in CPU points (both on 0..100).

    The paper reports ">92% accuracy" with max error < 8 points; we report
    100 minus the mean absolute difference between predicted and measured
    TCU, matching that reading.
    """
    predicted = np.asarray(predicted, dtype=np.float64)
    measured = np.asarray(measured, dtype=np.float64)
    return float(100.0 - np.abs(predicted - measured).mean())


def gain_ratio(
    thpt_ours: float, thpt_default: float, util_ours: float, util_default: float
) -> float:
    """Table 5 ratio: (throughput gain %) / (utilization gain %).

    > 1 means the proposed scheduler converts extra utilization into
    disproportionately more throughput (efficiency, not just busyness).
    """
    diff_thpt = (thpt_ours - thpt_default) / thpt_default * 100.0
    diff_util = (util_ours - util_default) / util_default * 100.0
    if diff_util == 0.0:
        return float("inf") if diff_thpt > 0 else 1.0
    return float(diff_thpt / diff_util)


def fairness_levels(
    rates: np.ndarray, targets: np.ndarray, priorities: np.ndarray | None = None
) -> np.ndarray:
    """(N,) weighted fairness level per tenant: ``(R/R_target) / priority``.

    The quantity the multi-tenant water-filling loop leximin-maximizes
    (Ghaderi et al.'s weighted max-min objective on satisfaction ratios);
    equal levels mean every tenant gets capacity proportional to
    ``priority * target``.
    """
    rates = np.asarray(rates, dtype=np.float64)
    targets = np.asarray(targets, dtype=np.float64)
    if priorities is None:
        priorities = np.ones_like(targets)
    return rates / (targets * np.asarray(priorities, dtype=np.float64))


def jain_index(values: np.ndarray) -> float:
    """Jain's fairness index of a nonnegative allocation vector:
    ``(sum x)^2 / (N * sum x^2)`` — 1.0 when perfectly even, 1/N when one
    tenant holds everything. Reported by the multi-tenant benchmark over
    the per-tenant fairness levels.
    """
    x = np.asarray(values, dtype=np.float64)
    denom = x.size * float((x * x).sum())
    if denom == 0.0:
        return 1.0
    return float(x.sum()) ** 2 / denom
