"""Profiling tables: e_ij, MET_ij per (task type, machine type) — paper §5.2.

The paper's pre-process profiling runs every task type on every machine type
at its saturation point and records:

* ``e_ij``   — average per-tuple execution time (seconds) of task type i on
               machine type j (Table 3);
* ``MET_ij`` — Storm's miscellaneous (framework) execution overhead, in CPU
               utilization points, recovered from eq. 5 at the saturation
               measurement;
* ``alpha_i`` — tuple division ratio per component (part of profiling data).

Units, faithful to the paper: TCU (task CPU utilization) is in *percent of
one machine's CPU* (0..100); e_ij · IR has units (seconds/tuple) ×
(tuples/second) × 100 ⇒ e_ij below are stored as "CPU-percent per
(tuple/second)" = seconds × 100. Table 3 lists e_ij in raw seconds; the
conversion by ×100 happens here once so that eq. 5 reads exactly
``TCU = e * IR + MET`` against a 100-point machine budget.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "Profile",
    "Cluster",
    "paper_profile",
    "paper_cluster",
    "rack_distance_matrix",
    "PAPER_E_TABLE3",
]

# Table 3 (seconds per tuple): rows = task types (lowCompute, midCompute,
# highCompute), columns = machine types (Machine1 Pentium, Machine2 Core i3,
# Machine3 Core i5).
#
# NOTE: Table 3 reads counter-intuitively (the Pentium shows the *smallest*
# per-tuple time). We reproduce the table verbatim — the algorithm only needs
# consistency between profiling and simulation, and we keep the paper's
# numbers as ground truth.
PAPER_E_TABLE3 = np.array(
    [
        [0.0581, 0.1070, 0.0916],  # lowCompute
        [0.1030, 0.1844, 0.1680],  # midCompute
        [0.1915, 0.3449, 0.3207],  # highCompute
    ]
)

# Per-machine-type miscellaneous Storm overhead (CPU points). The paper does
# not tabulate MET; it is recovered per (i, j) during profiling. We model it
# as a small per-machine-type constant, consistent with "independent of input
# rate".
PAPER_MET = np.array([1.5, 1.0, 1.2])

# Spout per-tuple emission cost (seconds): spouts generate rather than
# process; tiny but nonzero so spout placement matters slightly.
SPOUT_E = np.array([0.004, 0.006, 0.005])


@dataclasses.dataclass(frozen=True)
class Profile:
    """Profiling data P for a (task-type × machine-type) universe.

    Attributes:
      e: (n_task_types, n_machine_types) CPU-percent per unit input rate
         (i.e. seconds-per-tuple × 100).
      met: (n_task_types, n_machine_types) constant overhead in CPU points.
      type_names: task type names.
      machine_type_names: machine type names.
      mem: optional (n_task_types,) per-instance memory demand (memory
        units, rate-independent — an operator's working set does not grow
        with throughput). ``None`` (default) means memory is not modelled:
        every scoring path takes exactly the scalar-CPU code today's
        goldens pin (the R-Storm resource-vector extension, PAPERS.md).
    """

    e: np.ndarray
    met: np.ndarray
    type_names: tuple[str, ...]
    machine_type_names: tuple[str, ...]
    mem: np.ndarray | None = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "e", np.asarray(self.e, dtype=np.float64))
        object.__setattr__(self, "met", np.asarray(self.met, dtype=np.float64))
        if self.e.shape != self.met.shape:
            raise ValueError("e and met must have the same shape")
        if np.any(self.e < 0) or np.any(self.met < 0):
            raise ValueError("profiling constants must be non-negative")
        if self.mem is not None:
            mem = np.asarray(self.mem, dtype=np.float64)
            object.__setattr__(self, "mem", mem)
            if mem.shape != (self.e.shape[0],):
                raise ValueError("mem must be (n_task_types,)")
            if np.any(mem < 0):
                raise ValueError("memory demands must be non-negative")

    def with_mem(self, mem: np.ndarray) -> "Profile":
        """Same profiling tables plus a per-task-type memory demand vector."""
        return dataclasses.replace(self, mem=np.asarray(mem, dtype=np.float64))

    @property
    def n_task_types(self) -> int:
        return self.e.shape[0]

    @property
    def n_machine_types(self) -> int:
        return self.e.shape[1]


@dataclasses.dataclass(frozen=True)
class Cluster:
    """A concrete heterogeneous cluster: machine i has type machine_types[i].

    ``capacity`` is the per-machine CPU budget (the paper's MAC starting
    value, 100 points per machine).

    Resource-vector extension (R-Storm / Eidenbenz & Locher, PAPERS.md) —
    all three fields default to "not modelled", and with the defaults every
    scoring path is bit-identical to the scalar-CPU cost model:

    * ``mem_capacity`` — optional (m,) per-machine memory capacity. Paired
      with ``Profile.mem`` it becomes a *hard* constraint: a placement
      whose summed per-machine memory demand exceeds some machine's
      capacity is infeasible at any rate.
    * ``distance`` — optional (m, m) network distance matrix (same machine
      0, same rack 1, cross-rack k; must be non-negative with a zero
      diagonal). Inter-machine stream traffic is charged to both endpoint
      machines as extra CPU load, linear in the topology input rate, so
      R* keeps its closed form (``cost_model.network_unit_load``).
    * ``net_penalty`` — CPU points charged per (tuple/second × distance
      unit) on each endpoint of a cross-machine stream.
    """

    machine_types: np.ndarray
    capacity: np.ndarray
    profile: Profile
    mem_capacity: np.ndarray | None = None
    distance: np.ndarray | None = None
    net_penalty: float = 1.0

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "machine_types", np.asarray(self.machine_types, dtype=np.int64)
        )
        object.__setattr__(self, "capacity", np.asarray(self.capacity, dtype=np.float64))
        if self.machine_types.ndim != 1:
            raise ValueError("machine_types must be 1-D")
        if self.capacity.shape != self.machine_types.shape:
            raise ValueError("capacity must align with machine_types")
        if np.any(self.machine_types < 0) or np.any(
            self.machine_types >= self.profile.n_machine_types
        ):
            raise ValueError("machine type index out of profile range")
        if self.mem_capacity is not None:
            mem_capacity = np.asarray(self.mem_capacity, dtype=np.float64)
            object.__setattr__(self, "mem_capacity", mem_capacity)
            if mem_capacity.shape != self.machine_types.shape:
                raise ValueError("mem_capacity must align with machine_types")
            if np.any(mem_capacity < 0):
                raise ValueError("mem_capacity must be non-negative")
        if self.distance is not None:
            m = self.machine_types.shape[0]
            distance = np.asarray(self.distance, dtype=np.float64)
            object.__setattr__(self, "distance", distance)
            if distance.shape != (m, m):
                raise ValueError("distance must be (n_machines, n_machines)")
            if np.any(distance < 0):
                raise ValueError("distances must be non-negative")
            if np.any(np.diagonal(distance) != 0.0):
                raise ValueError("same-machine distance must be 0")
            if float(self.net_penalty) < 0.0:
                raise ValueError("net_penalty must be non-negative")

    @property
    def n_machines(self) -> int:
        return int(self.machine_types.shape[0])

    # ------------------------------------------------- resource predicates

    @property
    def has_memory(self) -> bool:
        """True when the memory hard constraint is active (demand *and*
        capacity modelled); otherwise memory never masks a placement."""
        return self.mem_capacity is not None and self.profile.mem is not None

    @property
    def has_network(self) -> bool:
        """True when a distance matrix is attached (the cut-traffic CPU
        term participates in scoring)."""
        return self.distance is not None

    @property
    def has_resources(self) -> bool:
        return self.has_memory or self.has_network

    def with_capacity(
        self, capacity: np.ndarray, mem_capacity: np.ndarray | None = None
    ) -> "Cluster":
        """Same machines, different per-machine capacity vector.

        The streaming runtime's drift scenarios (machine slowdown/removal)
        re-score placements against the *instantaneous* capacity; a removed
        machine is capacity 0.0 (the closed form then scores any placement
        with fixed MET on it as infeasible). Distance / memory / penalty
        fields are carried over unchanged; pass ``mem_capacity`` to
        substitute a residual memory vector as well (the multi-tenant
        residual view).
        """
        capacity = np.asarray(capacity, dtype=np.float64)
        if capacity.shape != self.machine_types.shape:
            raise ValueError("capacity must align with machine_types")
        return dataclasses.replace(
            self,
            capacity=capacity,
            mem_capacity=self.mem_capacity if mem_capacity is None else mem_capacity,
        )

    def with_resources(
        self,
        mem_capacity: np.ndarray | None = None,
        distance: np.ndarray | None = None,
        net_penalty: float | None = None,
    ) -> "Cluster":
        """Attach (or replace) resource-vector fields; None keeps a field."""
        return dataclasses.replace(
            self,
            mem_capacity=self.mem_capacity if mem_capacity is None else np.asarray(
                mem_capacity, dtype=np.float64
            ),
            distance=self.distance if distance is None else np.asarray(
                distance, dtype=np.float64
            ),
            net_penalty=self.net_penalty if net_penalty is None else float(net_penalty),
        )

    def without_network(self) -> "Cluster":
        """Distance-blind view: same machines/memory, no cut-traffic term
        (benchmark baseline for network-aware vs CPU-only placement)."""
        return dataclasses.replace(self, distance=None, net_penalty=1.0)

    def subcluster(
        self, machines: np.ndarray, capacity: np.ndarray | None = None
    ) -> "Cluster":
        """Restriction to ``machines`` (index array), carrying every
        resource field — the distance matrix restricts to the kept rows and
        columns. Used by the runtime controller's alive-subcluster replans.
        """
        machines = np.asarray(machines, dtype=np.int64)
        return Cluster(
            machine_types=self.machine_types[machines],
            capacity=self.capacity[machines] if capacity is None else capacity,
            profile=self.profile,
            mem_capacity=(
                None if self.mem_capacity is None else self.mem_capacity[machines]
            ),
            distance=(
                None
                if self.distance is None
                else self.distance[np.ix_(machines, machines)]
            ),
            net_penalty=self.net_penalty,
        )

    def e_for(self, task_types: np.ndarray) -> np.ndarray:
        """(len(task_types), n_machines) e matrix for concrete machines."""
        return self.profile.e[np.asarray(task_types)][:, self.machine_types]

    def met_for(self, task_types: np.ndarray) -> np.ndarray:
        return self.profile.met[np.asarray(task_types)][:, self.machine_types]

    def mem_for(self, task_types: np.ndarray) -> np.ndarray:
        """(len(task_types),) per-instance memory demand (zeros when memory
        is not modelled — machine-independent, unlike ``e_for``)."""
        task_types = np.asarray(task_types)
        if self.profile.mem is None:
            return np.zeros(task_types.shape, dtype=np.float64)
        return self.profile.mem[task_types]


def rack_distance_matrix(
    rack_of: np.ndarray,
    same_rack: float = 1.0,
    cross_rack: float = 2.0,
) -> np.ndarray:
    """(m, m) distance matrix from a per-machine rack id vector.

    The R-Storm distance model: same machine 0, same rack ``same_rack``
    (default 1), different racks ``cross_rack`` (default 2 — pass the
    paper-calibrated k for the actual fabric). Symmetric, zero diagonal.
    """
    rack_of = np.asarray(rack_of, dtype=np.int64)
    if rack_of.ndim != 1:
        raise ValueError("rack_of must be 1-D")
    same = rack_of[:, None] == rack_of[None, :]
    dist = np.where(same, float(same_rack), float(cross_rack))
    np.fill_diagonal(dist, 0.0)
    return dist


def paper_profile() -> Profile:
    """Task types: 0=spout, 1=lowCompute, 2=midCompute, 3=highCompute."""
    e_seconds = np.concatenate([SPOUT_E[None, :], PAPER_E_TABLE3], axis=0)
    e = e_seconds * 100.0  # CPU points per (tuple/second)
    met = np.broadcast_to(PAPER_MET[None, :], e.shape).copy()
    met[0] *= 0.5  # spouts carry less framework overhead
    return Profile(
        e=e,
        met=met,
        type_names=("spout", "lowCompute", "midCompute", "highCompute"),
        machine_type_names=("pentium", "core_i3", "core_i5"),
    )


def paper_cluster(
    counts: tuple[int, int, int] = (1, 1, 1), profile: Profile | None = None
) -> Cluster:
    """The paper's worker cluster: Machine1 Pentium, Machine2/4 i3, Machine3 i5.

    §6.1 uses three worker nodes (one i3 is the master). ``counts`` gives the
    number of machines per type — (1, 1, 1) is the paper's worker set;
    Table 4 scenarios use (2,2,2), (10,10,10), (20,70,90).
    """
    profile = profile or paper_profile()
    types = np.concatenate(
        [np.full(c, t, dtype=np.int64) for t, c in enumerate(counts)]
    )
    return Cluster(
        machine_types=types,
        capacity=np.full(types.shape, 100.0),
        profile=profile,
    )
