"""Algorithm 1 — FirstAssignment (paper §5.3).

Takes the user topology graph and profiling data; emits the minimal
execution topology graph (one instance per component), each instance placed
on the machine with the least predicted TCU (eq. 5) at the initial topology
input rate R0, accounting for load already placed on each machine.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import cost_model
from repro_torch.core.graph import ExecutionGraph, UserGraph
from repro_torch.core.profiles import Cluster

__all__ = ["first_assignment"]


def first_assignment(utg: UserGraph, cluster: Cluster, r0: float) -> ExecutionGraph:
    """One instance per component, greedily placed by least predicted TCU.

    Components are visited in topological order so each component's input
    rate (eq. 6) is known before it is placed. Ties on TCU break toward the
    machine with the most remaining capacity so the minimal graph never
    stacks everything on one node.
    """
    cir = cost_model.component_rates(utg, r0)  # one instance each => IR = CIR
    util = np.zeros(cluster.n_machines, dtype=np.float64)
    placement = np.zeros(utg.n_components, dtype=np.int64)
    # Hard memory constraint (resource-vector clusters): machines whose
    # remaining memory cannot hold the instance are masked out of the TCU
    # ranking; the scalar-CPU default never builds the mask, so its lexsort
    # keys are byte-identical to before.
    mem_used = (
        np.zeros(cluster.n_machines, dtype=np.float64)
        if cluster.has_memory
        else None
    )

    for i in utg.topo_order():
        ttype = int(utg.component_types[i])
        e_row = cluster.profile.e[ttype][cluster.machine_types]      # (m,)
        met_row = cluster.profile.met[ttype][cluster.machine_types]  # (m,)
        tcu = e_row * cir[i] + met_row                               # eq. 5
        mac_after = cluster.capacity - (util + tcu)
        tcu_key = np.round(tcu, 9)
        if mem_used is not None:
            mem_i = float(cluster.profile.mem[ttype])
            fits = mem_used + mem_i <= cluster.mem_capacity
            if fits.any():
                tcu_key = np.where(fits, tcu_key, np.inf)
            # else: nothing fits — fall through to the memory-blind rule
            # (the schedule is infeasible either way; R* masks it to 0).
        # Least-TCU machine; among near-ties prefer max remaining capacity.
        order = np.lexsort((-mac_after, tcu_key))
        best = int(order[0])
        placement[i] = best
        util[best] += tcu[best]
        if mem_used is not None:
            mem_used[best] += mem_i

    return ExecutionGraph(
        utg=utg,
        n_instances=np.ones(utg.n_components, dtype=np.int64),
        assignment=[np.array([placement[i]]) for i in range(utg.n_components)],
    )
