"""Storm's default scheduler: Round-Robin task assignment (paper §2.3).

The default scheduler maps executors to worker processes in a simple
round-robin over available slots, oblivious to machine computing power. The
user supplies the instance counts (in Storm the parallelism hints are part of
the submitted topology); for fair comparisons the benchmarks reuse the
instance counts discovered by the proposed scheduler (§6.3: "we first run our
algorithm to determine the number of instances for each component ... Now we
can fairly compare only the effectiveness of scheduling policies").
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.graph import ExecutionGraph, UserGraph
from repro_torch.core.profiles import Cluster

__all__ = ["round_robin_schedule"]


def round_robin_schedule(
    utg: UserGraph,
    cluster: Cluster,
    n_instances: np.ndarray,
    start: int = 0,
) -> ExecutionGraph:
    """Assign tasks (in eq. 3 flattened order) cyclically over machines."""
    n_instances = np.asarray(n_instances, dtype=np.int64)
    total = int(n_instances.sum())
    order = (start + np.arange(total)) % cluster.n_machines
    assignment: list[np.ndarray] = []
    off = 0
    for i in range(utg.n_components):
        k = int(n_instances[i])
        assignment.append(order[off : off + k].copy())
        off += k
    return ExecutionGraph(utg=utg, n_instances=n_instances, assignment=assignment)
