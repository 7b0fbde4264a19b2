"""Build the port's graph and cluster objects from the reference's.

Reads a ``repro.core`` object's attributes (NumPy arrays, tuples, floats)
without importing ``repro``, so tests can feed one problem to both
packages. Arrays are copied.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.graph import ExecutionGraph, FieldsGrouping, UserGraph
from repro_torch.core.profiles import Cluster, Profile

__all__ = ["user_graph", "execution_graph", "profile", "cluster"]


def _copy(x):
    return None if x is None else np.array(x, copy=True)


def user_graph(ref) -> UserGraph:
    """Port ``UserGraph`` with the same components, edges, ratios and
    fields groupings as the reference ``ref``."""
    return UserGraph(
        name=ref.name,
        component_types=_copy(ref.component_types),
        edges=tuple(tuple(e) for e in ref.edges),
        alpha=_copy(ref.alpha),
        groupings=tuple(
            FieldsGrouping(
                edge=tuple(g.edge),
                n_keys=g.n_keys,
                zipf_s=g.zipf_s,
                state_per_tuple=g.state_per_tuple,
            )
            for g in ref.groupings
        ),
    )


def execution_graph(ref, utg: UserGraph | None = None) -> ExecutionGraph:
    """Port ``ExecutionGraph``; pass ``utg`` to share one converted UTG
    (a ``SkewModel`` checks topology identity)."""
    return ExecutionGraph(
        utg=user_graph(ref.utg) if utg is None else utg,
        n_instances=_copy(ref.n_instances),
        assignment=[_copy(a) for a in ref.assignment],
    )


def profile(ref) -> Profile:
    return Profile(
        e=_copy(ref.e),
        met=_copy(ref.met),
        type_names=tuple(ref.type_names),
        machine_type_names=tuple(ref.machine_type_names),
        mem=_copy(ref.mem),
    )


def cluster(ref) -> Cluster:
    return Cluster(
        machine_types=_copy(ref.machine_types),
        capacity=_copy(ref.capacity),
        profile=profile(ref.profile),
        mem_capacity=_copy(ref.mem_capacity),
        distance=_copy(ref.distance),
        net_penalty=float(ref.net_penalty),
    )
