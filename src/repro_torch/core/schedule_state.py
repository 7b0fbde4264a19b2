"""Incremental scheduling engine: flat ScheduleState + closed-form stepping.

Port of ``repro.core.schedule_state``. The state and its O(m) deltas, the
closed-form R* stepping and its exact ``Fraction`` arbitration are host
bookkeeping and stay NumPy, as in the reference (see its docstring and
docs/architecture.md for the derivation):

1. **Flat structure-of-arrays state** — an (n_components, n_machines)
   count matrix plus per-component instance totals; adding an instance is
   an O(m) delta, rollback a snapshot/restore.
2. **Closed-form rate stepping** — eq. 5/6 are linear in the rate, so
   ``R* = min_w (cap_w - met_w) / var_w``; rates within a relative band of
   R* are decided in exact rational arithmetic on the cached coefficients.
3. **Closed-form growth feasibility** — a vectorized (n_targets, m) bound
   rejects target counts; the exact greedy runs only for admitted ones.

Batched candidate scoring (``score_task_machine_batch``, behind the
refine/optimal engines) runs on torch tensors on an explicit device
through ``cost_model.closed_form_rates``.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from repro_torch.core import cost_model
from repro_torch.core.graph import ExecutionGraph, UserGraph
from repro_torch.core.profiles import Cluster

__all__ = ["ScheduleState", "maximize_throughput_incremental"]

# Relative half-width of the float pre-filter around the closed-form R*.
# Rates outside the band are decided by the float comparison alone (the
# float R* is within a few ulps of the exact rational value, far inside
# 1e-9 relative); rates inside the band are decided exactly, in rational
# arithmetic over the cached linear coefficients (`feasible_linear_exact`).
_RSTAR_GUARD = 1e-9


class ScheduleState:
    """Flat, incrementally-updatable schedule state (structure of arrays).

    Instead of per-instance objects, the state stores:

    * ``n_instances``   (n,)   — instance count per component;
    * ``comp_counts``   (n, m) — instances of component c on machine w;
    * ``assignment``    list of per-component machine-index lists, in the
      order instances were added (preserves ``with_new_instance`` append
      semantics so the final ETG is byte-identical to the reference path);
    * cached profile slices ``e_cm``/``met_cm`` (n, m) for the concrete
      cluster, and the unit-rate component input rates ``cir_unit`` (n,).

    Per-machine accumulators ``met_load`` and ``var_load`` (d util / d R)
    are derived from the count matrix in O(n·m) and cached; structural
    mutations invalidate the cache. All mutation is O(m) per added
    instance.
    """

    __slots__ = (
        "utg",
        "cluster",
        "n_instances",
        "assignment",
        "comp_counts",
        "e_cm",
        "met_cm",
        "cir_unit",
        "mem_c",
        "skew",
        "_met_load",
        "_var_load",
        "_mem_load",
        "_net_load",
        "_device_tables",
    )

    def __init__(
        self,
        utg: UserGraph,
        cluster: Cluster,
        etg: ExecutionGraph,
        skew: "cost_model.SkewModel | None" = None,
    ):
        self.utg = utg
        self.cluster = cluster
        self.n_instances = etg.n_instances.copy()
        self.assignment = [list(map(int, a)) for a in etg.assignment]
        n, m = utg.n_components, cluster.n_machines
        ttypes = utg.component_types
        self.e_cm = cluster.profile.e[ttypes][:, cluster.machine_types]
        self.met_cm = cluster.profile.met[ttypes][:, cluster.machine_types]
        self.cir_unit = cost_model.component_rates(utg, 1.0)
        self.mem_c = cluster.profile.mem[ttypes] if cluster.has_memory else None
        if skew is not None and skew.utg is not utg:
            raise ValueError("skew model was built for a different topology")
        self.skew = skew
        self.comp_counts = np.zeros((n, m), dtype=np.int64)
        for c, machines in enumerate(self.assignment):
            for w in machines:
                self.comp_counts[c, w] += 1
        self._met_load: np.ndarray | None = None
        self._var_load: np.ndarray | None = None
        self._mem_load: np.ndarray | None = None
        self._net_load: np.ndarray | None = None
        self._device_tables: dict = {}

    @classmethod
    def from_etg(
        cls,
        etg: ExecutionGraph,
        cluster: Cluster,
        skew: "cost_model.SkewModel | None" = None,
    ) -> "ScheduleState":
        return cls(etg.utg, cluster, etg, skew=skew)

    # ------------------------------------------------------------- loads

    @property
    def met_load(self) -> np.ndarray:
        """(m,) fixed (rate-independent) MET load per machine."""
        if self._met_load is None:
            self._met_load = (self.met_cm * self.comp_counts).sum(axis=0)
        return self._met_load

    def _skew_variable_load(self, cir: np.ndarray) -> np.ndarray:
        """(m,) variable load for a per-component input-rate vector,
        accumulated per instance: keyed components at their realized key
        shares, shuffle components at the exact even split. The single
        skew accumulation both ``var_load`` and ``utilization`` use."""
        var = np.zeros(self.cluster.n_machines, dtype=np.float64)
        for c in range(self.utg.n_components):
            nk = int(self.n_instances[c])
            frac = self.skew.instance_fractions(c, nk)
            w = np.asarray(self.assignment[c], dtype=np.int64)
            ir = np.full(nk, cir[c] / nk) if frac is None else cir[c] * frac
            np.add.at(var, w, self.e_cm[c, w] * ir)
        return var

    @property
    def var_load(self) -> np.ndarray:
        """(m,) d utilization / d rate per machine at the current structure."""
        if self._var_load is None:
            if self.skew is None:
                per_unit = self.cir_unit / self.n_instances
                self._var_load = (
                    self.e_cm * self.comp_counts * per_unit[:, None]
                ).sum(axis=0)
            else:
                # Keyed components: instances are no longer interchangeable
                # (each handles its own key share), so accumulate per
                # instance instead of per (component, machine) count.
                self._var_load = self._skew_variable_load(self.cir_unit)
        return self._var_load

    @property
    def mem_load(self) -> np.ndarray:
        """(m,) resident memory per machine (rate-independent hard resource).

        Accumulated per task via ``np.add.at`` so the floats match the batch
        scorer's memory-mask accumulation exactly. Zeros on clusters without
        a memory model.
        """
        if self._mem_load is None:
            load = np.zeros(self.cluster.n_machines, dtype=np.float64)
            if self.mem_c is not None:
                comp = np.repeat(
                    np.arange(self.utg.n_components), self.n_instances
                )
                np.add.at(load, self.task_machine(), self.mem_c[comp])
            self._mem_load = load
        return self._mem_load

    @property
    def net_load(self) -> np.ndarray:
        """(m,) d network-load / d rate per machine — the cut-traffic term.

        ``cost_model.network_unit_load`` on the current placement (the same
        operands the batch scorer uses, so incremental and batched scores
        agree), computed on the CPU. Recomputed lazily after structural mutations, like the
        other load caches. Zeros on distance-free clusters.
        """
        if self._net_load is None:
            if not self.cluster.has_network:
                self._net_load = np.zeros(
                    self.cluster.n_machines, dtype=np.float64
                )
            else:
                comp = np.repeat(
                    np.arange(self.utg.n_components), self.n_instances
                )
                if self.skew is None:
                    unit_ir = (self.cir_unit / self.n_instances)[comp]
                else:
                    unit_ir = self.skew.per_task_unit_ir(self.n_instances)
                self._net_load = cost_model.network_unit_load(
                    self.task_machine()[None, :],
                    comp,
                    unit_ir,
                    self.utg.alpha,
                    self.cir_unit,
                    self.utg.edges,
                    self.cluster.distance,
                    self.cluster.net_penalty,
                    device="cpu",
                )[0].numpy()
        return self._net_load

    def utilization(self, rate: float) -> np.ndarray:
        """(m,) predicted machine utilization at topology input rate ``rate``.

        Uses the same eq. 6 propagation as the reference (``component_rates``
        at the actual rate, not ``cir_unit * rate``) so per-chunk TCUs match
        the reference floats exactly; the per-machine summation is collapsed
        from per-task to per-component, which can differ from the
        reference's ``np.add.at`` accumulation in the last ulp. With a skew
        model, keyed components accumulate per instance at their realized
        key shares (the skew-aware utilization bound).
        """
        cir = cost_model.component_rates(self.utg, rate)
        if self.skew is not None:
            util = self.met_load + self._skew_variable_load(cir)
        else:
            per_inst = cir / self.n_instances
            util = self.met_load + (
                self.e_cm * self.comp_counts * per_inst[:, None]
            ).sum(axis=0)
        if self.cluster.has_network:
            util = util + rate * self.net_load
        return util

    def feasible(self, rate: float) -> bool:
        """Reference feasibility: every machine's MAC >= 0 at ``rate``."""
        return bool(np.all(self.cluster.capacity - self.utilization(rate) >= 0.0))

    def max_stable_rate(self) -> float:
        """Closed-form R* = min_w (cap_w - met_w) / (var_w + net_w).

        Paper eq. 5 linearity; the cut-traffic term is linear in R too, so
        folding ``net_load`` into the variable coefficient keeps the closed
        form exact. Memory is rate-independent, so an over-memory machine
        makes the placement infeasible at any rate (R* = 0).
        """
        head = self.cluster.capacity - self.met_load
        if np.any(head < 0.0):
            return 0.0
        if self.cluster.has_memory and np.any(
            self.mem_load > self.cluster.mem_capacity
        ):
            return 0.0
        var = self.var_load
        if self.cluster.has_network:
            var = var + self.net_load
        with np.errstate(divide="ignore"):
            limits = np.where(var > 0.0, head / np.maximum(var, 1e-300), np.inf)
        return float(max(np.min(limits), 0.0))

    def max_stable_rate_exact(self) -> "Fraction | None":
        """Exact rational R* of the linear load model (``None`` = unbounded).

        Treats the cached float coefficients as exact rationals, so
        ``rate`` is stable iff ``Fraction(rate) <= max_stable_rate_exact()``
        — the feasibility boundary is a hard number, with no float-rounding
        band around it. A negative result means the rate-independent load
        alone (MET, or the hard memory constraint) already exceeds some
        machine's capacity. The cut-traffic coefficient enters the rational
        arithmetic exactly (``Fraction(var) + Fraction(net)``).
        """
        if self.cluster.has_memory and np.any(
            self.mem_load > self.cluster.mem_capacity
        ):
            return Fraction(-1)
        best: Fraction | None = None
        for cap_w, met_w, var_w, net_w in zip(
            self.cluster.capacity.tolist(),
            self.met_load.tolist(),
            self.var_load.tolist(),
            self._net_list(),
        ):
            head = Fraction(cap_w) - Fraction(met_w)
            var = Fraction(var_w) + Fraction(net_w)
            if var > 0:
                lim = head / var
            elif head < 0:
                return Fraction(-1)
            else:
                continue
            if best is None or lim < best:
                best = lim
        return best

    def _net_list(self) -> list[float]:
        """Per-machine cut-traffic coefficients for the exact paths (all
        zeros on distance-free clusters, without touching the cache)."""
        if not self.cluster.has_network:
            return [0.0] * self.cluster.n_machines
        return self.net_load.tolist()

    def feasible_linear_exact(self, rate: float) -> bool:
        """Exact feasibility of the linear model at ``rate``.

        Evaluates ``met_load_w + rate * var_load_w <= cap_w`` per machine in
        rational arithmetic over the cached float coefficients — the
        arbiter for rates inside the float pre-filter band around R*.
        """
        return self.first_over_machine_exact(rate) is None

    def first_over_machine_exact(self, rate: float) -> "int | None":
        """First machine (reference index order) over capacity at ``rate``
        under the exact linear model, or ``None`` if every machine fits.
        A machine over its memory capacity is over at any rate."""
        r = Fraction(rate)
        mem_over = (
            self.mem_load > self.cluster.mem_capacity
            if self.cluster.has_memory
            else None
        )
        for w, (cap_w, met_w, var_w, net_w) in enumerate(
            zip(
                self.cluster.capacity.tolist(),
                self.met_load.tolist(),
                self.var_load.tolist(),
                self._net_list(),
            )
        ):
            if mem_over is not None and mem_over[w]:
                return w
            util = Fraction(met_w) + r * (Fraction(var_w) + Fraction(net_w))
            if util > Fraction(cap_w):
                return w
        return None

    # --------------------------------------------------------- mutation

    def add_instance(self, component: int, machine: int) -> None:
        """O(m) delta update: append one instance of ``component`` on ``machine``."""
        self.comp_counts[component, machine] += 1
        self.n_instances[component] += 1
        self.assignment[component].append(int(machine))
        self._met_load = None
        self._var_load = None
        self._mem_load = None
        self._net_load = None

    def relocate_instance(self, component: int, k: int, machine: int) -> None:
        """O(1) delta: move instance (component, k) to ``machine``.

        Instance counts are unchanged, so the per-instance split (eq. 6) is
        untouched — only two entries of the count matrix move.
        """
        src = self.assignment[component][k]
        self.comp_counts[component, src] -= 1
        self.comp_counts[component, machine] += 1
        self.assignment[component][k] = int(machine)
        self._met_load = None
        self._var_load = None
        self._mem_load = None
        self._net_load = None

    def swap_instances(self, ca: int, ka: int, cb: int, kb: int) -> None:
        """O(1) delta: exchange the machines of instances (ca, ka) and (cb, kb)."""
        wa = self.assignment[ca][ka]
        wb = self.assignment[cb][kb]
        self.relocate_instance(ca, ka, wb)
        self.relocate_instance(cb, kb, wa)

    def drop_instance(self, component: int, k: int) -> None:
        """O(m) delta: remove instance (component, k); the component's stream
        re-splits over the remaining instances (eq. 6)."""
        if int(self.n_instances[component]) < 2:
            raise ValueError("every component needs >= 1 instance (paper constraint)")
        w = self.assignment[component].pop(k)
        self.comp_counts[component, w] -= 1
        self.n_instances[component] -= 1
        self._met_load = None
        self._var_load = None
        self._mem_load = None
        self._net_load = None

    def evacuate_machines(self, dead: np.ndarray, rate: float) -> int:
        """Relocate every instance hosted on a ``dead``-masked machine.

        A hill climb scoring closed-form throughput cannot escape the
        0-throughput plateau when *several* instances sit on a dead (or
        draining) machine — no single move restores feasibility — so such
        machines are drained greedily first: each stranded instance moves
        to the feasible non-dead machine with the least chunk TCU (ties
        toward most remaining head, ``_greedy_place``'s rule), and
        ``refine`` polishes from there. Returns the number of relocations.
        The same primitive serves machine *failure* (capacity already 0)
        and planned *drain* (capacity-notice scale-in: pass the mask of
        machines dead in the lookahead capacity).
        """
        from repro_torch.core.maximize_throughput import _least_tcu_machine

        dead = np.asarray(dead, dtype=bool)
        if not dead.any():
            return 0
        cir = cost_model.component_rates(self.utg, rate)
        per_inst = cir / self.n_instances
        util = self.utilization(rate)
        mem = self.mem_load.copy() if self.cluster.has_memory else None
        moves = 0
        for c in range(self.utg.n_components):
            tcu_w = self.e_cm[c] * per_inst[c] + self.met_cm[c]
            for k, w in enumerate(self.assignment[c]):
                if not dead[w]:
                    continue
                # Dead machines get -inf head so the shared rule never
                # picks them; when nothing fits, least-overloaded alive.
                head = np.where(dead, -np.inf, self.cluster.capacity - util - tcu_w)
                if mem is not None:
                    # Machines the instance's memory would not fit on are
                    # masked out of the fit rule; the nothing-fits fallback
                    # stays least-overloaded-alive (memory-blind — refine
                    # cannot polish from a stranded instance).
                    fit_head = np.where(
                        mem + self.mem_c[c] > self.cluster.mem_capacity,
                        -np.inf,
                        head,
                    )
                else:
                    fit_head = head
                target = _least_tcu_machine(tcu_w, fit_head)
                if target is None:
                    target = int(np.argmax(head))
                self.relocate_instance(c, k, target)
                util[w] -= tcu_w[w]
                util[target] += tcu_w[target]
                if mem is not None:
                    mem[w] -= self.mem_c[c]
                    mem[target] += self.mem_c[c]
                moves += 1
        return moves

    # ------------------------------------------------------ batch export

    def task_machine(self) -> np.ndarray:
        """(T,) flattened machine per task (paper eq. 3 order), for use as the
        base row when building candidate batches for ``max_stable_rate_batch``."""
        flat: list[int] = []
        for machines in self.assignment:
            flat.extend(machines)
        return np.asarray(flat, dtype=np.int64)

    def component_offsets(self) -> np.ndarray:
        """(n+1,) start offset of each component's block in the flattened
        task order; ``offsets[c] + k`` is the column of instance (c, k)."""
        return np.concatenate(
            [np.zeros(1, dtype=np.int64), np.cumsum(self.n_instances)]
        )

    def template_etg(self, n_instances: np.ndarray | None = None) -> ExecutionGraph:
        """Shape-only ETG for batched scoring (assignment is a placeholder).

        ``max_stable_rate_batch`` reads only the UTG and instance counts from
        its template — candidate placements come in as (B, T) rows — so the
        export is O(n), no deep copy of the real assignment.
        """
        if n_instances is None:
            n_instances = self.n_instances
        n_instances = np.asarray(n_instances, dtype=np.int64)
        return ExecutionGraph(
            utg=self.utg,
            n_instances=n_instances.copy(),
            assignment=[np.zeros(int(k), dtype=np.int64) for k in n_instances],
        )

    def score_task_machine_batch(
        self,
        task_machine: np.ndarray,
        n_instances: np.ndarray | None = None,
        device: str | torch.device = "cuda",
    ) -> tuple[np.ndarray, np.ndarray]:
        """Closed-form (rate, throughput) of B exported candidate placements.

        Bit-identical to ``cost_model.max_stable_rate_batch`` on a template
        with the same instance counts — both call the one
        ``cost_model.closed_form_rates`` — but skips per-call
        ``ExecutionGraph`` construction and the Python eq. 6 walk by reusing
        the cached ``e_cm``/``met_cm``/``cir_unit`` slices (kept on the
        device across sweeps). This is the scoring entry point behind the
        refine/optimal batch engines.

        Args:
          task_machine: (B, T') candidate rows, T' = sum of each row's
            instance counts (every row must share one task total).
          n_instances: per-component counts for the candidates — a shared
            (n,) vector (defaults to the current state's counts), or a
            (B, n) matrix giving every row its *own* counts. Per-row scores
            are bit-identical to scoring each row against its own
            shared-count template.
          device: ``"cuda"`` (default: the hand-written kernel; raises
            without a card) or ``"cpu"`` (the plain PyTorch version); both
            give the reference's NumPy floats bit for bit.
        """
        from repro_torch.core.simulator import resolve_closed_form_device

        n_inst = self.n_instances if n_instances is None else np.asarray(
            n_instances, dtype=np.int64
        )
        n = self.utg.n_components
        task_machine = np.asarray(task_machine, dtype=np.int64)
        if task_machine.ndim != 2:
            raise ValueError("task_machine must be (B, sum(n_instances))")
        if n_inst.ndim == 2:
            if n_inst.shape != (task_machine.shape[0], n):
                raise ValueError("per-row n_instances must be (B, n)")
            comp, unit_ir = cost_model.per_row_task_maps(
                self.cir_unit, n_inst, task_machine.shape[1]
            )                                             # each (B, T)
            if self.skew is not None:
                unit_ir = self.skew.per_row_unit_ir(n_inst)
        else:
            comp = np.repeat(np.arange(n), n_inst)
            if task_machine.shape[1] != comp.shape[0]:
                raise ValueError("task_machine must be (B, sum(n_instances))")
            if self.skew is not None:
                # Keyed components' unit IR comes from the realized
                # per-instance fractions.
                unit_ir = self.skew.per_task_unit_ir(n_inst)
            else:
                # Per-component division then gather: per-element operands
                # match instance_rates()' per-task division exactly.
                unit_ir = (self.cir_unit / n_inst)[comp]
        regime = (
            "skew" if self.skew is not None
            else "per_row" if n_inst.ndim == 2
            else "shared"
        )
        dev = resolve_closed_form_device(
            device, task_machine.size, regime=regime,
            n_machines=self.cluster.n_machines, site="score_task_machine_batch",
        )
        task_machine, comp, net_var, mem_c, mem_cap = self._resource_operands(
            task_machine, comp, unit_ir, dev
        )
        e_cm, met_cm, capacity = self._tables(dev)
        return cost_model.closed_form_rates(
            task_machine, comp, unit_ir, e_cm, met_cm, capacity,
            net_var=net_var, mem_c=mem_c, mem_capacity=mem_cap, device=dev,
        )

    def _tables(self, dev: torch.device) -> tuple[torch.Tensor, ...]:
        """(e_cm, met_cm, capacity) as float64 tensors on ``dev``, copied
        once per device (the cluster never changes under a state)."""
        tables = self._device_tables.get(dev)
        if tables is None:
            tables = tuple(
                torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64)).to(dev)
                for x in (self.e_cm, self.met_cm, self.cluster.capacity)
            )
            self._device_tables[dev] = tables
        return tables

    def _resource_operands(
        self,
        task_machine: np.ndarray,
        comp: np.ndarray,
        unit_ir: np.ndarray,
        device: torch.device,
    ) -> tuple:
        """(task_machine, comp, net_var, mem_c, mem_capacity) of a candidate
        batch (``cost_model._scoring_operands``) — the extras all ``None``
        on scalar-CPU clusters, which score on the scalar kernel."""
        if not self.cluster.has_resources:
            return task_machine, comp, None, None, None
        return cost_model._scoring_operands(
            self.cluster,
            task_machine,
            comp,
            unit_ir,
            self.utg.alpha,
            self.cir_unit,
            self.utg.edges,
            self.utg.component_types,
            device=device,
        )

    def snapshot(self) -> tuple:
        return (
            self.n_instances.copy(),
            self.comp_counts.copy(),
            [list(a) for a in self.assignment],
        )

    def restore(self, snap: tuple) -> None:
        self.n_instances = snap[0].copy()
        self.comp_counts = snap[1].copy()
        self.assignment = [list(a) for a in snap[2]]
        self._met_load = None
        self._var_load = None
        self._mem_load = None
        self._net_load = None

    def to_etg(self) -> ExecutionGraph:
        return ExecutionGraph(
            utg=self.utg,
            n_instances=self.n_instances.copy(),
            assignment=[np.asarray(a, dtype=np.int64) for a in self.assignment],
        )


def _grow_component_fast(
    state: ScheduleState,
    component: int,
    rate: float,
    max_extra: int | None = None,
) -> int:
    """Incremental equivalent of the reference ``_grow_component``.

    Scans candidate target counts with the closed-form per-machine capacity
    bound (one vectorized (n_targets, m) pass), then runs the exact greedy
    (``_greedy_place``, the same code path as the reference engine) for
    admitted targets only. Mutates ``state`` in place on success.

    Returns the number of instances added (0 if no target packs).
    """
    from repro_torch.core.maximize_throughput import _greedy_place

    cluster = state.cluster
    cap = cluster.capacity
    m = cluster.n_machines
    n0 = int(state.n_instances[component])
    cir_vec = cost_model.component_rates(state.utg, rate)
    cir = cir_vec[component]
    e_row = state.e_cm[component]
    met_row = state.met_cm[component]
    existing_counts = state.comp_counts[component]

    # Machine load from everything except this component (its variable part
    # re-splits with the new count; reference subtracts the same quantity).
    per_inst = cir_vec / state.n_instances
    util = state.met_load + (
        state.e_cm * state.comp_counts * per_inst[:, None]
    ).sum(axis=0)
    if cluster.has_network:
        # Current cut-traffic load enters the head as a fixed charge (the
        # grown component's own re-split is approximated as unchanged —
        # the main loop re-scores the true generalized R* after growth).
        util = util + rate * state.net_load
    own_tcu = e_row * (cir / n0) + met_row
    base_load = util - existing_counts * own_tcu

    # Hard memory constraint: at most floor(room / mem_c) new instances per
    # machine (no float slack — memory infeasibility cannot be admitted;
    # under-counting an exact fit by one is merely conservative).
    mem_new = None
    if cluster.has_memory and float(state.mem_c[component]) > 0.0:
        mem_room = np.maximum(cluster.mem_capacity - state.mem_load, 0.0)
        mem_new = np.floor(mem_room / float(state.mem_c[component]))

    max_target = n0 + (max_extra if max_extra is not None else max(2 * n0, 2 * m, 16))
    targets = np.arange(n0 + 1, max_target + 1)
    if targets.size == 0:
        return 0

    # Closed-form packing bound: with a fixed per-machine chunk TCU, greedy
    # placement order cannot change how many chunks fit, so target t packs
    # iff sum_w max(0, floor(avail_w / tcu_w(t)) - counts_w) >= t - n0.
    # The +1e-9 slack absorbs the reference's repeated-addition rounding;
    # admitted targets are confirmed by the exact greedy below.
    tcu_t = e_row[None, :] * (cir / targets)[:, None] + met_row[None, :]
    avail = cap - base_load
    with np.errstate(divide="ignore", invalid="ignore"):
        fit = np.floor(avail[None, :] / tcu_t + 1e-9)
    fit = np.where(np.isfinite(fit), fit, 0.0)
    # A zero-cost chunk (e == met == 0 for this type pair) fits without
    # bound on any machine that is not already over capacity.
    unlimited = (tcu_t <= 0.0) & (avail[None, :] >= 0.0)
    fit = np.where(unlimited, float(max_target), fit)
    n_new_w = np.clip(fit - existing_counts[None, :], 0.0, None)
    if mem_new is not None:
        n_new_w = np.minimum(n_new_w, mem_new[None, :])
    n_new = n_new_w.sum(axis=1)
    admitted = targets[n_new >= (targets - n0)]

    for target in admitted:
        target = int(target)
        per_ir = cir / target
        tcu = e_row * per_ir + met_row
        placed = _greedy_place(
            cap, base_load, existing_counts, tcu, target - n0, max_new=mem_new
        )
        if placed is None:
            continue
        for w in placed:
            state.add_instance(component, w)
        return len(placed)
    return 0


def _hottest_component(state: ScheduleState, machine: int, rate: float) -> int:
    """Component owning the hottest task on ``machine`` (reference semantics).

    All instances of a component on one machine share one TCU, and tasks are
    ordered component-major, so the reference ``argmax`` over per-task TCUs
    reduces to a first-max argmax over per-component TCUs.
    """
    cir = cost_model.component_rates(state.utg, rate)
    per_inst = cir / state.n_instances
    tcu_c = state.e_cm[:, machine] * per_inst + state.met_cm[:, machine]
    present = state.comp_counts[:, machine] > 0
    return int(np.argmax(np.where(present, tcu_c, -np.inf)))


def maximize_throughput_incremental(
    etg: ExecutionGraph,
    cluster: Cluster,
    r0: float,
    rate_epsilon: float = 1.0,
    max_iters: int = 100_000,
):
    """Algorithm 2 with the incremental engine; reference control flow."""
    # Imported here, not at module level: maximize_throughput imports this
    # module lazily, and keeping both imports function-local makes the
    # non-cycle obvious regardless of which module loads first.
    from repro_torch.core.maximize_throughput import Schedule

    state = ScheduleState.from_etg(etg, cluster)
    scale = 1.0
    current_rate = float(r0)
    final_snap = state.snapshot()
    final_rate = 0.0
    trace: list[tuple[int, str, float]] = []
    # Closed-form R* for the current structure; None = needs recompute.
    rstar: float | None = None

    it = 0
    while it < max_iters:
        it += 1
        if rstar is None:
            rstar = state.max_stable_rate()
        # Closed-form feasibility: far from R* the float comparison alone
        # decides (float R* is within ulps of the exact rational value);
        # inside the pre-filter band, exact rational arithmetic over the
        # linear coefficients is the arbiter — no heuristic re-check.
        if current_rate <= rstar * (1.0 - _RSTAR_GUARD):
            feasible = True
        elif current_rate >= rstar * (1.0 + _RSTAR_GUARD):
            feasible = False
        else:
            feasible = state.feasible_linear_exact(current_rate)
        if feasible:
            final_snap = state.snapshot()
            final_rate = current_rate
            increment = current_rate / scale
            if increment < rate_epsilon:
                trace.append((it, "terminate", current_rate))
                break
            current_rate += increment
            trace.append((it, "raise_rate", current_rate))
            continue
        # Over-utilization: hottest task on the first over-utilized machine
        # (reference index order) under the same linear model; the exact
        # rational scan runs only when float rounding hides the machine.
        var = state.var_load
        if cluster.has_network:
            var = var + state.net_load
        head = cluster.capacity - (state.met_load + current_rate * var)
        over_idx = np.flatnonzero(head < 0.0)
        if over_idx.size:
            over_w = int(over_idx[0])
        else:
            exact_w = state.first_over_machine_exact(current_rate)
            over_w = int(np.argmin(head)) if exact_w is None else exact_w
        component = _hottest_component(state, over_w, current_rate)
        added = _grow_component_fast(state, component, current_rate)
        if added:
            rstar = None
            trace.append((it, f"new_instance:c{component}x{added}", current_rate))
            continue
        # No candidate machine (reference lines 11-16).
        if current_rate > scale and final_rate > 0.0:
            scale *= 2.0
            state.restore(final_snap)
            rstar = None
            current_rate = final_rate + final_rate / scale
            trace.append((it, "backoff", current_rate))
            continue
        trace.append((it, "terminate", final_rate))
        break

    state.restore(final_snap)
    final_etg = state.to_etg()
    pred_final = cost_model.predict(final_etg, cluster, final_rate)
    return Schedule(
        etg=final_etg,
        rate=final_rate,
        predicted_throughput=pred_final.throughput,
        iterations=it,
        trace=trace,
    )
