"""Optimal scheduler — exhaustive search over the design space (paper §3, §6).

The paper's brute-force baseline enumerates every (instance-count vector,
placement) combination, evaluates the overall throughput of each, and keeps
the best. The paper reports ~18 hours for 27 405 possibilities on a 4-socket
Xeon server; our beyond-paper speedup comes from five observations:

1. Instances of one component are interchangeable, so a placement is fully
   described by *how many* instances of each component land on each machine —
   a composition of N_i into m parts — collapsing the m^N assignment space
   into a multiset space.
2. The paper's objective (max throughput s.t. no machine over-utilized) is
   linear in the topology input rate, so each placement's score — its
   *maximum stable throughput* — has a closed form (``max_stable_rate``);
   no iterative simulation is needed to score a candidate.
3. All placements sharing an instance-count vector score in one vectorized
   batch (``max_stable_rate_batch``).
4. Machines of one type (and capacity) are interchangeable, so only one
   canonical representative per within-type permutation class needs
   scoring (``prune_symmetry``) — the rest are duplicates by symmetry.
5. The closed form also bounds a whole composition class from above
   without enumerating it (``prune_bound``): relaxing the per-machine
   constraints to their aggregate sum — and each component to its best
   single machine — gives an O(n·m) R* upper bound, so classes that
   cannot strictly beat the running best are skipped entirely.

Port of ``repro.core.optimal``'s vectorized (``engine="state"``) search:
each composition class is enumerated as a dense (B, n, m) count tensor on
the host — product indices, the canonical-symmetry filter and the
per-machine cap are chunked NumPy array ops — and every chunk's (B, T)
task->machine rows score in one batched sweep on the requested device.
docs/architecture.md derives the design.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.cost_model import (
    component_rates,
    max_stable_rate,
    max_stable_rate_batch,
)
from repro_torch.core.graph import ExecutionGraph, UserGraph
from repro_torch.core.profiles import Cluster

__all__ = ["OptimalResult", "optimal_schedule", "placement_score"]

# Relative inflation applied to the closed-form class bound before pruning:
# the bound math is exact in real arithmetic, so this only has to absorb
# float rounding between the bound's reductions and the scorer's (1e-15
# scale) — a pruned class then provably cannot contain a strict improvement.
_BOUND_SLACK = 1e-12


def _class_bound(
    n_inst: np.ndarray,
    cir_unit: np.ndarray,
    e_cm: np.ndarray,
    met_cm: np.ndarray,
    capacity: np.ndarray,
    mem_c: np.ndarray | None = None,
    mem_capacity: np.ndarray | None = None,
) -> float:
    """Upper bound on max stable throughput over *all* placements with
    instance counts ``n_inst`` — no enumeration, O(n·m).

    Two closed-form relaxations of ``R* = min_w (cap_w - met_w) / var_w``
    (both ignore that tasks compete for the same machines, so they can only
    over-estimate):

    * **aggregate** — summing the per-machine feasibility constraints gives
      ``R <= (Σ cap_w - Σ met_w) / Σ var_w``; lower-bounding each task's
      fixed/variable contribution by its cheapest machine keeps it an upper
      bound.
    * **per-task** — any task of component c lands on *some* machine w, and
      that machine's constraint alone gives
      ``R <= (cap_w - met_cw) / (e_cw · u_c)``; the best case is the max
      over machines, and every component must satisfy its own, so the min
      over components bounds R.

    On resource-vector clusters the hard memory constraint enters as two
    more valid relaxations (``mem_c`` per-instance demand, ``mem_capacity``
    per machine): a class whose aggregate memory demand exceeds the
    cluster's total memory — or one of whose components fits on no machine
    even alone — is infeasible at any rate. The cut-traffic term is
    *ignored*: network load only ever adds to the variable coefficient, so
    a net-blind bound remains an upper bound on the generalized objective.

    Returns the bounded throughput (``R_ub * Σ_c CIR_c(1)``), inflated by
    ``_BOUND_SLACK``; ``inf`` when unbounded, ``0.0`` when the class is
    infeasible at any rate (some component's fixed MET alone exceeds every
    machine's capacity, or total fixed MET exceeds total capacity).
    """
    u = cir_unit / n_inst                               # (n,) per-task rate
    total_met_min = float((n_inst * met_cm.min(axis=1)).sum())
    sum_cap = float(capacity.sum())
    if sum_cap < total_met_min:
        return 0.0
    total_var_min = float((n_inst * (e_cm.min(axis=1) * u)).sum())
    r_agg = (
        np.inf
        if total_var_min <= 0.0
        else (sum_cap - total_met_min) / total_var_min
    )
    head = capacity[None, :] - met_cm                   # (n, m)
    ok = head >= 0.0
    if mem_c is not None:
        if float((n_inst * mem_c).sum()) > float(mem_capacity.sum()):
            return 0.0  # aggregate memory demand exceeds the cluster's
        ok &= mem_c[:, None] <= mem_capacity[None, :]   # (n, m)
    if not np.all(ok.any(axis=1)):
        return 0.0  # some component fits on no machine even alone
    var = e_cm * u[:, None]                             # (n, m)
    with np.errstate(divide="ignore", over="ignore"):
        lim = np.where(var > 0.0, head / np.maximum(var, 1e-300), np.inf)
    lim = np.where(ok, lim, -np.inf)
    r_ub = min(r_agg, float(lim.max(axis=1).min()))
    if not np.isfinite(r_ub):
        return np.inf
    return r_ub * float(cir_unit.sum()) * (1.0 + _BOUND_SLACK)


def placement_score(etg: ExecutionGraph, cluster: Cluster) -> float:
    """Score of a placement: its maximum stable throughput (paper eq. 2)."""
    _, thpt = max_stable_rate(etg, cluster)
    return float(thpt)


def _ordered_classes(
    utg: UserGraph,
    max_total_tasks: int,
    prune_bound: bool,
    cir_unit: np.ndarray,
    e_cm: np.ndarray,
    met_cm: np.ndarray,
    capacity: np.ndarray,
    mem_c: np.ndarray | None = None,
    mem_capacity: np.ndarray | None = None,
) -> list[tuple[int, np.ndarray, float]]:
    """Composition classes as (original rank, n_inst, bound) in processing
    order.

    With the beam bound active, classes are visited **best-bound-first**
    (stable descending sort on the closed-form bound): the strongest
    classes establish a high running best immediately, and because bounds
    are sorted the search can stop at the first class whose bound cannot
    beat it — every remaining class is pruned in one step. Without the
    bound, the original enumeration order is kept (bounds are +inf).

    The original rank rides along for tie-breaking: the reported optimum
    is the same candidate the original-order search reports (see the
    acceptance rule in the engines), so reordering is invisible in
    results — only ``candidates_evaluated``/``classes_pruned`` move.
    """
    n = utg.n_components
    vecs = [
        np.asarray(extra, dtype=np.int64) + 1
        for extra in _compositions_upto(max_total_tasks - n, n)
    ]
    if not prune_bound:
        return [(i, v, np.inf) for i, v in enumerate(vecs)]
    bounds = np.array(
        [
            _class_bound(v, cir_unit, e_cm, met_cm, capacity, mem_c, mem_capacity)
            for v in vecs
        ]
    )
    order = np.argsort(-bounds, kind="stable")
    return [(int(i), vecs[i], float(bounds[i])) for i in order]


def _incumbent_seed(
    utg: UserGraph,
    cluster: Cluster,
    max_total_tasks: int,
    max_per_machine: int | None,
    device,
) -> tuple[ExecutionGraph, float] | None:
    """``schedule()+refine()`` as the search's initial lower bound.

    The heuristic pipeline's result is a real placement, so its throughput
    is a valid incumbent — classes the bound proves can't beat it are
    pruned before the first candidate is scored. Only used when the
    incumbent actually lies inside the search space (instance budget and
    per-machine cap), otherwise seeding could report an optimum the space
    doesn't contain.
    """
    from repro_torch.core.maximize_throughput import schedule
    from repro_torch.core.refine import refine

    sched = schedule(utg, cluster, r0=1.0, rate_epsilon=1.0)
    # The caller's device is forwarded; either device scores the reference
    # floats, so the seed (and hence the prune boundary and the golden
    # candidate counts) match the reference's.
    inc = refine(sched.etg, cluster, device=device)
    if inc.etg.total_tasks > max_total_tasks:
        return None
    if max_per_machine is not None:
        per_machine = np.bincount(
            inc.etg.task_machine(), minlength=cluster.n_machines
        )
        if np.any(per_machine > max_per_machine):
            return None
    return inc.etg, float(inc.throughput)


def _compositions(total: int, parts: int) -> Iterator[tuple[int, ...]]:
    """All ways to write ``total`` as an ordered sum of ``parts`` >= 0 ints."""
    if parts == 1:
        yield (total,)
        return
    for head in range(total + 1):
        for rest in _compositions(total - head, parts - 1):
            yield (head, *rest)


def _symmetry_runs(cluster: Cluster) -> list[tuple[int, int]]:
    """Maximal runs [start, end) of consecutive identical machines.

    Machines with the same type and capacity are interchangeable: permuting
    them permutes a placement without changing its score. Only runs of
    length >= 2 matter.
    """
    key = list(zip(cluster.machine_types.tolist(), cluster.capacity.tolist()))
    runs: list[tuple[int, int]] = []
    start = 0
    for w in range(1, cluster.n_machines + 1):
        if w == cluster.n_machines or key[w] != key[start]:
            if w - start >= 2:
                runs.append((start, w))
            start = w
    return runs


def _canonical_mask(
    counts: np.ndarray, runs: list[tuple[int, int]]
) -> np.ndarray:
    """Vectorized ``_is_canonical`` over a (B, n, m) count tensor.

    A chain is non-increasing iff every adjacent column pair is; a column
    pair violates iff the first component where they differ increases.
    """
    B = counts.shape[0]
    keep = np.ones(B, dtype=bool)
    for start, end in runs:
        for w in range(start + 1, end):
            diff = counts[:, :, w] - counts[:, :, w - 1]     # (B, n)
            nz = diff != 0
            has = nz.any(axis=1)
            first = np.argmax(nz, axis=1)
            sign = diff[np.arange(B), first]
            keep &= ~(has & (sign > 0))
    return keep


def _counts_to_task_machine(counts: np.ndarray, n_inst: np.ndarray) -> np.ndarray:
    """(B, n, m) per-machine counts -> (B, T) flat machine rows (eq. 3 order).

    Per component, task j of the block lands on the number of machines whose
    cumulative count is <= j — a vectorized run-length decode that matches
    ``_counts_to_assignment``'s machine-major expansion exactly.
    """
    blocks = []
    for c in range(n_inst.shape[0]):
        k = int(n_inst[c])
        cums = counts[:, c, :].cumsum(axis=1)                # (B, m)
        j = np.arange(k)
        blocks.append((cums[:, None, :] <= j[None, :, None]).sum(axis=2))
    return np.concatenate(blocks, axis=1).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class OptimalResult:
    etg: ExecutionGraph
    rate: float
    throughput: float
    candidates_evaluated: int
    classes_pruned: int = 0


def optimal_schedule(
    utg: UserGraph,
    cluster: Cluster,
    max_total_tasks: int,
    max_per_machine: int | None = None,
    batch_size: int = 8192,
    prune_symmetry: bool = True,
    prune_bound: bool = True,
    seed_incumbent: bool = True,
    device: str | torch.device = "cuda",
) -> OptimalResult:
    """Exhaustive search. Exponential — only for small benchmark topologies.

    Args:
      utg: the user topology.
      cluster: the heterogeneous cluster.
      max_total_tasks: cap on sum of instances (the paper's eq. 1 bound,
        ``sum k_j``).
      max_per_machine: optional per-machine k_j cap on simultaneous tasks.
      batch_size: placements scored per batched sweep.
      prune_symmetry: evaluate only canonical representatives of each
        within-type machine-permutation class (machines of one type and
        capacity are interchangeable for scoring).
      prune_bound: skip whole composition classes whose closed-form R*
        beam bound (``_class_bound``) cannot beat the best throughput found
        so far, visiting classes best-bound-first; an original-rank
        tie-break keeps the reported placement identical to the
        original-order search's. ``classes_pruned`` counts the skips.
      seed_incumbent: start the beam bound from ``schedule()+refine()``'s
        throughput (a valid lower bound) when that placement lies inside
        the search space.
      device: where candidate sweeps are scored — ``"cuda"`` (default: the
        hand-written kernel; raises without a card) or ``"cpu"`` (the plain
        PyTorch version). Scores are the reference's NumPy floats bit for
        bit on either, so the optimum, ``candidates_evaluated`` and
        ``classes_pruned`` match ``repro``'s.
    """
    return _optimal_state(
        utg, cluster, max_total_tasks, max_per_machine, batch_size,
        prune_symmetry, prune_bound, device, seed_incumbent,
    )


def _optimal_state(
    utg: UserGraph,
    cluster: Cluster,
    max_total_tasks: int,
    max_per_machine: int | None,
    batch_size: int,
    prune_symmetry: bool,
    prune_bound: bool,
    device,
    seed_incumbent: bool,
) -> OptimalResult:
    """Vectorized engine: dense count tensors per composition class.

    For each instance-count vector, candidate placements are rows of the
    cross product of per-component composition tables. Chunks of product
    indices unravel (C order — the same order ``itertools.product`` walks)
    into (B, n, m) count tensors; the canonical filter and per-machine cap
    are boolean masks; survivors convert to (B, T) rows and score in one
    ``max_stable_rate_batch`` sweep per chunk. Scores are row-independent
    and winners are first strict maxima, so chunk boundaries cannot change
    the result and the returned placement, score and
    ``candidates_evaluated`` match the reference engine exactly (both
    engines also apply the same ``_class_bound`` skips at the same class
    boundaries with identical running bests).
    """
    n = utg.n_components
    m = cluster.n_machines
    runs = _symmetry_runs(cluster) if prune_symmetry else []
    cir_unit = component_rates(utg, 1.0)
    e_cm = cluster.profile.e[utg.component_types][:, cluster.machine_types]
    met_cm = cluster.profile.met[utg.component_types][:, cluster.machine_types]
    mem_c = (
        cluster.profile.mem[utg.component_types] if cluster.has_memory else None
    )
    best_etg: ExecutionGraph | None = None
    best_thpt = -1.0
    best_rank = np.inf
    evaluated = 0
    pruned_classes = 0
    if prune_bound and seed_incumbent:
        seeded = _incumbent_seed(utg, cluster, max_total_tasks, max_per_machine, device)
        if seeded is not None:
            best_etg, best_thpt = seeded

    ordered = _ordered_classes(
        utg, max_total_tasks, prune_bound, cir_unit, e_cm, met_cm,
        cluster.capacity, mem_c, cluster.mem_capacity,
    )
    for pos, (rank, n_inst, bound) in enumerate(ordered):
        if prune_bound and bound < best_thpt:
            pruned_classes += len(ordered) - pos
            break
        template = ExecutionGraph(
            utg=utg,
            n_instances=n_inst,
            assignment=[np.zeros(int(k), dtype=np.int64) for k in n_inst],
        )
        opts = [
            np.asarray(list(_compositions(int(k), m)), dtype=np.int64)
            for k in n_inst
        ]
        sizes = [o.shape[0] for o in opts]
        total = math.prod(sizes)  # Python int: exact for huge spaces
        for start in range(0, total, batch_size):
            idx = np.arange(start, min(start + batch_size, total))
            sel = np.unravel_index(idx, sizes)
            counts = np.stack(
                [opts[c][sel[c]] for c in range(n)], axis=1
            )  # (B, n, m)
            keep = np.ones(idx.size, dtype=bool)
            if runs:
                keep &= _canonical_mask(counts, runs)
            if max_per_machine is not None:
                keep &= (counts.sum(axis=1) <= max_per_machine).all(axis=1)
            counts = counts[keep]
            if counts.shape[0] == 0:
                continue
            tm = _counts_to_task_machine(counts, n_inst)
            _, thpt = max_stable_rate_batch(template, cluster, tm, device=device)
            evaluated += tm.shape[0]
            top = int(np.argmax(thpt))
            # Same acceptance rule as the reference engine: strict
            # improvement, or an exact tie from an earlier original rank.
            if float(thpt[top]) > best_thpt or (
                float(thpt[top]) == best_thpt and rank < best_rank
            ):
                best_thpt = float(thpt[top])
                best_rank = rank
                assignment, off = [], 0
                for k in n_inst:
                    assignment.append(tm[top, off : off + int(k)].copy())
                    off += int(k)
                best_etg = ExecutionGraph(
                    utg=utg, n_instances=n_inst.copy(), assignment=assignment
                )

    if best_etg is None:
        raise ValueError("design space empty — raise max_total_tasks")
    rate, thpt = max_stable_rate(best_etg, cluster)
    return OptimalResult(
        etg=best_etg,
        rate=float(rate),
        throughput=float(thpt),
        candidates_evaluated=evaluated,
        classes_pruned=pruned_classes,
    )


def _compositions_upto(budget: int, parts: int) -> Iterator[tuple[int, ...]]:
    """All non-negative integer vectors of length ``parts`` with sum <= budget."""
    for total in range(budget + 1):
        yield from _compositions(total, parts)
