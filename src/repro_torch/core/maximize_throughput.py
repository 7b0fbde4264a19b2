"""Algorithm 2 — MaximizeThroughput (paper §5.4).

Progressive scale-up: starting from the minimal ETG of Algorithm 1 at rate
R0, repeatedly

1. predict MACs at the current rate (eq. 5/6);
2. if no machine is over-utilized: commit the state as the latest stable
   schedule and raise the rate by ``Current_IR / Scale``;
3. otherwise: take a new instance of the component owning the *hottest*
   task on the *first* over-utilized machine and place it on the most
   suitable machine (least predicted TCU among machines that keep the whole
   schedule feasible); adding an instance re-splits that component's stream
   (eq. 6) and relieves the hot machine;
4. if no machine can host the new instance: halve the rate increment
   (``Scale *= 2``), roll back to the latest stable schedule, and retry;
5. terminate when the increment is exhausted (``Current_IR <= Scale`` in the
   paper; equivalently the next additive increment drops below a rate
   epsilon) — the cluster is saturated.

Returns the final stable ETG, its input rate, and an iteration trace used by
benchmarks and tests. Host-side NumPy, as in the reference: the loop is
sequential and O(m) per step.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.first_assignment import first_assignment
from repro_torch.core.graph import ExecutionGraph, UserGraph
from repro_torch.core.profiles import Cluster

__all__ = ["Schedule", "maximize_throughput", "schedule"]


@dataclasses.dataclass
class Schedule:
    """Result of the proposed scheduler.

    Attributes:
      etg: final execution topology graph with placement.
      rate: maximum stable topology input rate found.
      predicted_throughput: eq. 2 objective at ``rate``.
      iterations: number of Algorithm-2 loop iterations.
      trace: (iteration, event, rate) tuples for inspection.
    """

    etg: ExecutionGraph
    rate: float
    predicted_throughput: float
    iterations: int
    trace: list[tuple[int, str, float]]


def _least_tcu_machine(tcu: np.ndarray, head: np.ndarray) -> int | None:
    """Machine with the least (9-digit-quantized) TCU among those whose
    remaining head is >= 0; ties break toward most remaining head.

    The single copy of the placement tie-break rule: greedy growth (both
    engines, via ``_greedy_place``) and the streaming runtime's
    dead-machine evacuation select machines through this exact lexsort,
    so the rule cannot drift between paths. Returns None when no machine
    has head.
    """
    feasible = head >= 0.0
    if not np.any(feasible):
        return None
    cand_tcu = np.where(feasible, tcu, np.inf)
    return int(np.lexsort((-head, np.round(cand_tcu, 9)))[0])


def _greedy_place(
    capacity: np.ndarray,
    base_load: np.ndarray,
    existing_counts: np.ndarray,
    tcu: np.ndarray,
    k: int,
    max_new: np.ndarray | None = None,
) -> list[int] | None:
    """Greedily place ``k`` equal chunks of per-machine cost ``tcu``.

    Shared by the reference and incremental engines — the engines'
    equivalence contract depends on this exact feasibility check, lexsort
    tie-breaking and float accumulation order, so there is one copy.

    ``max_new`` optionally caps the number of *new* chunks per machine (the
    hard memory constraint on resource-vector clusters); ``None`` — the
    default and the scalar-CPU path — leaves the rule untouched.

    Returns the chosen machines in placement order, or None if some chunk
    does not fit.
    """
    load = base_load + existing_counts * tcu
    budget = None if max_new is None else np.asarray(max_new, dtype=np.float64).copy()
    placed: list[int] = []
    for _ in range(k):
        head = capacity - (load + tcu)
        if budget is not None:
            head = np.where(budget >= 1.0, head, -np.inf)
        w = _least_tcu_machine(tcu, head)
        if w is None:
            return None
        placed.append(w)
        load[w] += tcu[w]
        if budget is not None:
            budget[w] -= 1.0
    return placed


def maximize_throughput(
    etg: ExecutionGraph,
    cluster: Cluster,
    r0: float,
    rate_epsilon: float = 1.0,
    max_iters: int = 100_000,
) -> Schedule:
    """Algorithm 2, faithful to the paper's control flow, on the incremental
    ``ScheduleState`` engine (``schedule_state.maximize_throughput_incremental``
    — the reference's default engine; its copy-everything ``"reference"``
    engine stays in ``repro`` as the semantic oracle).
    """
    from repro_torch.core.schedule_state import maximize_throughput_incremental

    return maximize_throughput_incremental(
        etg, cluster, r0, rate_epsilon=rate_epsilon, max_iters=max_iters
    )


def schedule(
    utg: UserGraph,
    cluster: Cluster,
    r0: float = 1.0,
    rate_epsilon: float = 1.0,
) -> Schedule:
    """End-to-end proposed scheduler: Algorithm 1 then Algorithm 2."""
    etg0 = first_assignment(utg, cluster, r0)
    return maximize_throughput(etg0, cluster, r0, rate_epsilon=rate_epsilon)
