"""Topology graphs: user topology graph (UTG) and execution topology graph (ETG).

Faithful to the paper's model (Section 2.2):

* A *user topology graph* (UTG) is a DAG of components. Component 0 is by
  convention the spout (source); every other component is a bolt. Each
  component ``i`` has a *type* (indexing into the profiling tables) and a
  *tuple division ratio* ``alpha_i`` (eq. 6): the average ratio of output
  tuples to input tuples.

* An *execution topology graph* (ETG) fixes a parallelism degree
  ``n_instances[i] >= 1`` per component and an assignment of every instance
  to a machine.

Instances of component ``i`` are identified by the pair ``(i, k)`` with
``k < n_instances[i]``; a flattened global task index follows the paper's
eq. 3 ordering (all instances of component 0, then component 1, ...).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "FieldsGrouping",
    "UserGraph",
    "ExecutionGraph",
    "linear_topology",
    "diamond_topology",
    "star_topology",
    "rolling_count_topology",
    "keyed_rolling_count_topology",
    "unique_visitor_topology",
    "wide_fanout_topology",
]


@dataclasses.dataclass(frozen=True)
class FieldsGrouping:
    """Keyed routing spec for one edge (Storm's *fields grouping*).

    Tuples on the edge carry a key drawn from a Zipf-distributed key space:
    key k of ``n_keys`` has probability mass proportional to
    ``(k + 1) ** -zipf_s`` (``zipf_s = 0`` is uniform). Every key is pinned
    to one downstream instance by a deterministic hash→instance map, so a
    hot key concentrates load on a single instance — the within-operator
    imbalance the paper's eq. 6 even split cannot express.

    The spec is *structural*: which instance each key lands on (the hash
    values) is drawn at trace ``compile(seed)`` time like all other
    randomness (see ``runtime_stream.traces.KeyRealization``).

    ``state_per_tuple`` sizes the downstream operator's *keyed state*:
    state tuples retained per unit of the edge's tuple rate (a rolling
    counter keeps one window of per-key aggregates; a join keeps its
    buffered side). An instance's standing state is proportional to the
    key share it owns (``SkewModel.per_task_state``), so migrating a
    hot-key instance ships more state than a cold one. 0 (the default)
    means a stateless operator — migration stays priced by move count
    alone and the runtime behaves exactly as before.
    """

    edge: tuple[int, int]
    n_keys: int = 64
    zipf_s: float = 1.0
    state_per_tuple: float = 0.0

    def __post_init__(self) -> None:
        object.__setattr__(self, "edge", (int(self.edge[0]), int(self.edge[1])))
        if int(self.n_keys) < 1:
            raise ValueError("fields grouping needs at least one key")
        if not (float(self.zipf_s) >= 0.0):
            raise ValueError("zipf_s must be >= 0 (0 = uniform keys)")
        if not (float(self.state_per_tuple) >= 0.0):
            raise ValueError("state_per_tuple must be >= 0 (0 = stateless)")
        object.__setattr__(self, "n_keys", int(self.n_keys))
        object.__setattr__(self, "zipf_s", float(self.zipf_s))
        object.__setattr__(self, "state_per_tuple", float(self.state_per_tuple))


@dataclasses.dataclass(frozen=True)
class UserGraph:
    """The paper's UTG.

    Attributes:
      name: topology name (for reports).
      component_types: length-n int array; ``component_types[i]`` indexes the
        profiling table row for component i (its task *type*: e.g. lowCompute/
        midCompute/highCompute). The spout is component 0 and conventionally
        has its own type with near-zero cost.
      edges: list of (src, dst) component index pairs; must form a DAG with
        every non-spout component reachable from a spout.
      alpha: length-n float array, tuple division ratio per component
        (``OR = alpha * IR``). Spouts' alpha scales the injected rate.
      groupings: fields-grouped edges (``FieldsGrouping`` per keyed edge);
        every edge not listed uses shuffle grouping (the paper's default).
    """

    name: str
    component_types: np.ndarray
    edges: tuple[tuple[int, int], ...]
    alpha: np.ndarray
    groupings: tuple[FieldsGrouping, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "component_types", np.asarray(self.component_types, dtype=np.int64)
        )
        object.__setattr__(self, "alpha", np.asarray(self.alpha, dtype=np.float64))
        object.__setattr__(self, "edges", tuple((int(a), int(b)) for a, b in self.edges))
        object.__setattr__(self, "groupings", tuple(self.groupings))
        n = self.n_components
        if self.alpha.shape != (n,):
            raise ValueError(f"alpha must have shape ({n},), got {self.alpha.shape}")
        for a, b in self.edges:
            if not (0 <= a < n and 0 <= b < n):
                raise ValueError(f"edge ({a},{b}) out of range for {n} components")
            if a == b:
                raise ValueError("self-loops are not allowed (DAG)")
        seen: set[tuple[int, int]] = set()
        for g in self.groupings:
            if not isinstance(g, FieldsGrouping):
                raise ValueError("groupings must be FieldsGrouping instances")
            if g.edge not in self.edges:
                raise ValueError(f"fields grouping on unknown edge {g.edge}")
            if g.edge in seen:
                raise ValueError(f"duplicate grouping for edge {g.edge}")
            seen.add(g.edge)
        # Validate acyclicity + topological order computability.
        self.topo_order()

    @property
    def n_components(self) -> int:
        return int(self.component_types.shape[0])

    @property
    def sources(self) -> list[int]:
        """Components with no in-edges (spouts)."""
        indeg = np.zeros(self.n_components, dtype=np.int64)
        for _, b in self.edges:
            indeg[b] += 1
        return [i for i in range(self.n_components) if indeg[i] == 0]

    def parents(self, i: int) -> list[int]:
        return [a for a, b in self.edges if b == i]

    def children(self, i: int) -> list[int]:
        return [b for a, b in self.edges if a == i]

    def grouping(self, edge: tuple[int, int]) -> FieldsGrouping | None:
        """The fields grouping on ``edge``, or None (shuffle grouping)."""
        for g in self.groupings:
            if g.edge == edge:
                return g
        return None

    @property
    def keyed_components(self) -> list[int]:
        """Components with at least one fields-grouped in-edge, in index
        order — their per-instance input split departs from eq. 6."""
        return sorted({g.edge[1] for g in self.groupings})

    def with_groupings(self, *groupings: FieldsGrouping) -> "UserGraph":
        """Copy of this UTG with the given fields groupings (replaces any
        existing ones)."""
        return dataclasses.replace(self, groupings=tuple(groupings))

    def topo_order(self) -> list[int]:
        n = self.n_components
        indeg = np.zeros(n, dtype=np.int64)
        for _, b in self.edges:
            indeg[b] += 1
        order: list[int] = []
        stack = [i for i in range(n) if indeg[i] == 0]
        while stack:
            v = stack.pop()
            order.append(v)
            for c in self.children(v):
                indeg[c] -= 1
                if indeg[c] == 0:
                    stack.append(c)
        if len(order) != n:
            raise ValueError(f"topology '{self.name}' contains a cycle")
        return order


@dataclasses.dataclass
class ExecutionGraph:
    """The paper's ETG: instance counts + per-instance machine assignment.

    ``assignment[i]`` is an int array of length ``n_instances[i]`` whose k-th
    entry is the machine index hosting instance (i, k).
    """

    utg: UserGraph
    n_instances: np.ndarray
    assignment: list[np.ndarray]

    def __post_init__(self) -> None:
        self.n_instances = np.asarray(self.n_instances, dtype=np.int64)
        n = self.utg.n_components
        if self.n_instances.shape != (n,):
            raise ValueError("n_instances must have one entry per component")
        if np.any(self.n_instances < 1):
            raise ValueError("every component needs >= 1 instance (paper constraint)")
        if len(self.assignment) != n:
            raise ValueError("assignment must have one array per component")
        self.assignment = [np.asarray(a, dtype=np.int64) for a in self.assignment]
        for i, a in enumerate(self.assignment):
            if a.shape != (int(self.n_instances[i]),):
                raise ValueError(
                    f"component {i}: assignment length {a.shape} != "
                    f"n_instances {int(self.n_instances[i])}"
                )

    @property
    def total_tasks(self) -> int:
        return int(self.n_instances.sum())

    def copy(self) -> "ExecutionGraph":
        return ExecutionGraph(
            utg=self.utg,
            n_instances=self.n_instances.copy(),
            assignment=[a.copy() for a in self.assignment],
        )

    def task_component(self) -> np.ndarray:
        """Flattened map: global task index -> component index (paper eq. 3)."""
        return np.repeat(np.arange(self.utg.n_components), self.n_instances)

    def task_machine(self) -> np.ndarray:
        """Flattened map: global task index -> machine index."""
        if self.total_tasks == 0:
            return np.zeros(0, dtype=np.int64)
        return np.concatenate(self.assignment)

    def component_offsets(self) -> np.ndarray:
        """(n+1,) start offset of each component's task block in the
        flattened eq. 3 order — the single owner of the block-layout rule
        (``offsets[c] + k`` is the flat index of instance (c, k))."""
        return np.concatenate(
            [np.zeros(1, dtype=np.int64), np.cumsum(self.n_instances)]
        )

    def with_new_instance(self, component: int, machine: int) -> "ExecutionGraph":
        new = self.copy()
        new.n_instances[component] += 1
        new.assignment[component] = np.concatenate(
            [new.assignment[component], np.array([machine], dtype=np.int64)]
        )
        return new


# ---------------------------------------------------------------------------
# Micro-Benchmark topologies (Fig. 5) and Storm-Benchmark topologies (Fig. 7).
#
# Component type indices follow repro.core.profiles:
#   0=spout, 1=lowCompute, 2=midCompute, 3=highCompute.
# The gray (measured) bolt in Fig. 5 is the highCompute bolt.
# ---------------------------------------------------------------------------

SPOUT, LOW, MID, HIGH = 0, 1, 2, 3


def linear_topology(alpha: float = 1.0) -> UserGraph:
    """spout -> low -> mid -> high (Fig. 5, Linear)."""
    return UserGraph(
        name="linear",
        component_types=np.array([SPOUT, LOW, MID, HIGH]),
        edges=((0, 1), (1, 2), (2, 3)),
        alpha=np.array([1.0, alpha, alpha, alpha]),
    )


def diamond_topology(alpha: float = 1.0) -> UserGraph:
    """spout fans out to low/mid/low, all feed high (Fig. 5, Diamond)."""
    return UserGraph(
        name="diamond",
        component_types=np.array([SPOUT, LOW, MID, LOW, HIGH]),
        edges=((0, 1), (0, 2), (0, 3), (1, 4), (2, 4), (3, 4)),
        alpha=np.array([1.0, alpha, alpha, alpha, alpha]),
    )


def star_topology(alpha: float = 1.0) -> UserGraph:
    """two spouts -> high -> two sinks (Fig. 5, Star)."""
    return UserGraph(
        name="star",
        component_types=np.array([SPOUT, SPOUT, HIGH, LOW, MID]),
        edges=((0, 2), (1, 2), (2, 3), (2, 4)),
        alpha=np.array([1.0, 1.0, alpha, alpha, alpha]),
    )


def rolling_count_topology() -> UserGraph:
    """Storm-Benchmark RollingCount: spout -> split(bolt1) -> rolling-count(bolt2).

    bolt1 (sentence split) is the compute-heavy stage and fans each sentence
    into several words (alpha > 1); the per-word rolling counter is light.
    """
    return UserGraph(
        name="rolling_count",
        component_types=np.array([SPOUT, HIGH, LOW]),
        edges=((0, 1), (1, 2)),
        alpha=np.array([1.0, 4.0, 1.0]),
    )


def keyed_rolling_count_topology(
    n_keys: int = 32, zipf_s: float = 1.2, state_per_tuple: float = 0.0
) -> UserGraph:
    """RollingCount with its word->counter edge fields-grouped.

    The canonical keyed-stream shape: the split bolt fans sentences into
    words (alpha > 1) and each word is pinned to one rolling counter by
    fields grouping, so a Zipf-hot word concentrates load on one counter
    instance — the load-imbalance scenario family of ROADMAP open item 3.
    ``state_per_tuple > 0`` gives the counter keyed state (its per-key
    rolling windows) so migrations ship state proportional to key share.
    """
    return rolling_count_topology().with_groupings(
        FieldsGrouping(
            edge=(1, 2), n_keys=n_keys, zipf_s=zipf_s,
            state_per_tuple=state_per_tuple,
        )
    )


def unique_visitor_topology() -> UserGraph:
    """Storm-Benchmark UniqueVisitor: spout -> view parse(bolt1) -> distinct(bolt2)."""
    return UserGraph(
        name="unique_visitor",
        component_types=np.array([SPOUT, HIGH, HIGH]),
        edges=((0, 1), (1, 2)),
        alpha=np.array([1.0, 1.0, 1.0]),
    )


def wide_fanout_topology(n_mid: int = 8) -> UserGraph:
    """Spout fanning out to ``n_mid`` bolts (types cycling low/mid/high),
    all feeding one low-compute sink.

    Beyond-paper stress shape for wide topologies: with n components a
    refine round explores n single growth chains plus 2·C(n, 2) pair
    forks, which is what the lockstep chain explorer batches (see
    docs/architecture.md). Used by the wide golden equivalence tests and
    benchmarks/bench_refine.py's wide scenario."""
    n = n_mid + 2
    types = np.array([SPOUT] + [1 + (i % 3) for i in range(n_mid)] + [LOW])
    edges = tuple((0, j) for j in range(1, n_mid + 1)) + tuple(
        (j, n - 1) for j in range(1, n_mid + 1)
    )
    return UserGraph(
        name=f"wide{n_mid}",
        component_types=types,
        edges=edges,
        alpha=np.ones(n),
    )
