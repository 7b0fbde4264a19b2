"""Trace-driven streaming executor: a deterministic windowed event loop.

Executes a schedule (an ``ExecutionGraph`` on a ``Cluster``) against a
compiled workload trace in fixed-length windows. Per window, the loop is a
discrete-time fluid model of Storm's executor pipeline:

1. **Arrive.** Spouts emit the window's offered rate scaled by the current
   back-pressure throttle; each bolt receives its parents' *previous-window*
   processed output times the edge's tuple-division ratio alpha (eq. 6) —
   tuples travel one hop per window. A shuffle-grouped stream splits evenly
   over the component's instances; a fields-grouped edge routes each key's
   share to the instance its drawn hash pins it to
   (``KeyRealization.shares``, the deterministic hash→instance map), so
   hot keys land in single per-instance queues. Queues are bounded at
   ``max_queue`` tuples; overflow is dropped (and counted).
2. **Serve.** Every instance tries to drain its whole queue this window;
   its service demand prices at the profile tables (eq. 5:
   ``e·rate + MET``). A machine whose demand exceeds its windowed capacity
   applies proportional fair throttling — the same saturation model as the
   §6.3 simulator (``s_w = clip(head_w / var_w, 0, 1)``).
3. **Back-pressure.** When any queue crosses the high watermark the spout
   throttle halves (Storm 1.x-style spout back-pressure); when all queues
   drain below the low watermark it recovers multiplicatively.

Determinism: the loop is a pure function of the compiled trace (all
randomness lives in ``TraceSpec.compile(seed)``), so the same seed + spec
produce bit-identical event logs and metrics. The batch evaluator
(``eval_torch.evaluate_policies_batch``, the ``policy_scan`` kernel on a
card) mirrors this window step exactly and agrees to ~1e-9 on shared
scenarios (tested).

A controller (see ``controller.py``) may swap the placement between
windows; migrated/new instances pause for ``migration_pause`` windows
(their queues hold but do not serve), modeling restart downtime. Keyed
instances with operator state (``FieldsGrouping.state_per_tuple``)
additionally pause for the time their state takes to ship at
``state_transfer_rate`` — a hot-key instance pauses longer than a cold
one (``placement_transfer`` is the single owner of the who-moves /
how-much-state accounting the executor and the controller's cost/benefit
guard share).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math

import numpy as np

from repro_torch.core.graph import ExecutionGraph
from repro_torch.core.metrics import per_machine_utilization
from repro_torch.core.profiles import Cluster
from repro_torch.obs.trace import NULL_RECORDER
from repro_torch.runtime_stream.traces import CompiledTrace, TraceSpec

__all__ = [
    "RuntimeConfig",
    "RuntimeResult",
    "StreamExecutor",
    "MigrationTransfer",
    "placement_migrations",
    "placement_transfer",
    "transfer_pause_windows",
]


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Event-loop constants shared by the Python executor and the batch
    evaluator (both must see identical values for parity).

    Attributes:
      max_queue: per-instance queue bound (tuples); overflow is dropped.
      bp_high: queue fraction that trips spout back-pressure.
      bp_low: queue fraction below which the throttle recovers.
      throttle_down / throttle_up: multiplicative spout-throttle AIMD-style
        decrease/recovery factors.
      throttle_min: floor so a saturated spout keeps probing.
      migration_pause: windows a migrated or newly added instance pauses
        (queues hold, no service) after a placement change.
      state_transfer_rate: keyed-state tuples shippable per second while an
        instance migrates; a migrated instance holding S state tuples
        pauses ``migration_pause + ceil(S / (rate * window_s))`` windows.
        The default (inf) makes state transfer instantaneous — the
        state-blind runtime, bit-identical.
      capacity_notice: windows of advance notice the controller gets about
        capacity changes (``WindowObs.capacity_ahead`` — cloud removals
        are announced, e.g. spot-instance termination warnings). 0
        disables the lookahead.
    """

    max_queue: float = 500.0
    bp_high: float = 0.5
    bp_low: float = 0.1
    throttle_down: float = 0.5
    throttle_up: float = 1.25
    throttle_min: float = 0.05
    migration_pause: int = 1
    state_transfer_rate: float = float("inf")
    capacity_notice: int = 0


@dataclasses.dataclass(frozen=True)
class RuntimeResult:
    """Windowed metrics of one executed run (arrays indexed by window).

    ``machine_util`` follows ``core.metrics`` semantics: the sum of hosted
    tasks' TCU (eq. 5 at the *processed* rate) per machine. ``throughput``
    is the paper's eq. 2 objective — the sum of all task processing rates —
    measured per window. ``sustained_throughput()`` is the steady-state
    summary the benchmarks compare policies on.
    """

    name: str
    window_s: float
    offered: np.ndarray        # (W,) trace rate
    admitted: np.ndarray       # (W,) spout rate after back-pressure throttle
    throughput: np.ndarray     # (W,) sum of task processing rates
    dropped: np.ndarray        # (W,) tuples/s lost to full queues
    queue_total: np.ndarray    # (W,) total backlog (tuples)
    queue_max: np.ndarray      # (W,) deepest per-instance queue (tuples)
    machine_util: np.ndarray   # (W, m)
    throttle: np.ndarray       # (W,)
    migrations: np.ndarray     # (W,) instances moved/added by replans
    events: tuple[tuple[int, str], ...]
    final_etg: ExecutionGraph

    @property
    def n_windows(self) -> int:
        return int(self.throughput.shape[0])

    def sustained_throughput(self, tail_frac: float = 0.5) -> float:
        """Mean throughput over the trailing ``tail_frac`` of the horizon
        (the steady state after controllers/queues converge)."""
        start = int(self.n_windows * (1.0 - tail_frac))
        return float(self.throughput[start:].mean())

    def latency(self) -> np.ndarray:
        """(W,) per-window queueing-latency estimate in seconds: standing
        backlog over the window's service rate (Little's law, L = λ·T).
        Windows that serve nothing while holding backlog saturate at the
        horizon length — "unboundedly late" without an inf in the stats.
        Derived, not stored: it leaves the fingerprint unchanged."""
        horizon = self.n_windows * self.window_s
        with np.errstate(divide="ignore", invalid="ignore"):
            lat = np.where(
                self.queue_total > 0.0,
                self.queue_total / np.maximum(self.throughput, 1e-300),
                0.0,
            )
        return np.minimum(lat, horizon)

    def latency_slo_frac(self, slo_s: float, tail_frac: float = 0.5) -> float:
        """Fraction of the trailing ``tail_frac`` windows whose estimated
        queueing latency meets ``slo_s`` — the latency-SLO column the
        runtime benchmark records alongside sustained throughput."""
        start = int(self.n_windows * (1.0 - tail_frac))
        return float((self.latency()[start:] <= slo_s).mean())

    def fingerprint(self) -> str:
        """md5 over every metric array + the event log — two runs of the
        same seed/spec must produce equal fingerprints (bit-determinism)."""
        h = hashlib.md5()
        for arr in (
            self.offered, self.admitted, self.throughput, self.dropped,
            self.queue_total, self.queue_max, self.machine_util,
            self.throttle, self.migrations,
        ):
            h.update(np.ascontiguousarray(arr).tobytes())
        h.update(repr(self.events).encode())
        h.update(repr(self.final_etg.task_machine().tolist()).encode())
        return h.hexdigest()


def placement_migrations(old: ExecutionGraph, new: ExecutionGraph) -> int:
    """Instances that must start or move to turn ``old`` into ``new``.

    Per component, instances on a machine are interchangeable, so the cost
    is the multiset difference of per-machine counts: ``sum_w max(0,
    new_cw - old_cw)`` — newly added instances and relocations both count
    once; drops are free (a stopped instance ships no state). This is the
    flat *move count*; ``placement_transfer`` adds the state-weighted view
    (which instances restart and how much keyed state each must load).
    """
    m = 1 + max(
        (int(a.max()) for a in old.assignment + new.assignment if a.size),
        default=0,
    )
    total = 0
    for c in range(old.utg.n_components):
        oc = np.bincount(old.assignment[c], minlength=m)
        nc = np.bincount(new.assignment[c], minlength=m)
        total += int(np.clip(nc - oc, 0, None).sum())
    return total


@dataclasses.dataclass(frozen=True)
class MigrationTransfer:
    """State-aware cost of turning one placement into another.

    Attributes:
      moves: instances that restart (start, move, or — for keyed
        components whose instance count changed — rehash). Equals
        ``placement_migrations`` on shuffle-only topologies.
      state_shipped: total keyed state (state tuples) that must change
        hosts before the new placement serves at full strength.
      migrated: (T_new,) bool — per new-layout instance, does it restart.
      instance_state: (T_new,) state tuples each restarting instance must
        load (0 for carried-over instances and stateless components) —
        the executor prices each instance's migration pause from this,
        the controller guard the service lost while it sits paused.
    """

    moves: int
    state_shipped: float
    migrated: np.ndarray
    instance_state: np.ndarray


def placement_transfer(
    old: ExecutionGraph, new: ExecutionGraph, skew=None
) -> MigrationTransfer:
    """State-weighted migration accounting (the cost model the controller
    guard and the executor's pause mechanics share).

    Shuffle components keep the multiset rule of ``placement_migrations``
    (instances on a machine are interchangeable; the first ``old_cw``
    instances a machine retains carry over, the rest restart) and ship no
    state. Keyed components are *index-pinned* — the hash→instance map
    routes key k to instance ``hash_k % N`` — so instance k restarts iff
    its machine changed at index k; if the instance count changed, every
    key rehashes and the whole component restarts and reships its state.
    Each restarting instance loads the keyed state of the key share it
    owns under the *new* realization (``SkewModel.instance_state``): hot
    instances ship more. With ``skew=None`` the accounting is state-blind
    and multiset everywhere — drops remain free in every mode.
    """
    m = 1 + max(
        (int(a.max()) for a in old.assignment + new.assignment if a.size),
        default=0,
    )
    offsets = new.component_offsets()
    T_new = int(offsets[-1])
    migrated = np.zeros(T_new, dtype=bool)
    instance_state = np.zeros(T_new, dtype=np.float64)
    keyed = set() if skew is None else set(skew.keyed_components)
    moves = 0
    for c in range(old.utg.n_components):
        lo, hi = int(offsets[c]), int(offsets[c + 1])
        if c in keyed:
            n_old, n_new = int(old.n_instances[c]), int(new.n_instances[c])
            state_vec = skew.instance_state(c, n_new)
            if n_old != n_new:
                # Resize rehashes every key: the whole component restarts
                # and repartitions its state (Storm rebalance semantics).
                mig = np.ones(n_new, dtype=bool)
            else:
                mig = np.asarray(old.assignment[c]) != np.asarray(new.assignment[c])
            migrated[lo:hi] = mig
            instance_state[lo:hi] = np.where(mig, state_vec, 0.0)
            moves += int(mig.sum())
        else:
            keep = np.bincount(old.assignment[c], minlength=m)
            for k, w in enumerate(new.assignment[c]):
                if keep[w] > 0:
                    keep[w] -= 1
                else:
                    migrated[lo + k] = True
                    moves += 1
    return MigrationTransfer(
        moves=moves,
        state_shipped=float(instance_state.sum()),
        migrated=migrated,
        instance_state=instance_state,
    )


def transfer_pause_windows(
    transfer: MigrationTransfer, config: RuntimeConfig, window_s: float
) -> np.ndarray:
    """(T_new,) pause windows per new-layout instance: restarting
    instances hold for ``migration_pause`` plus however long their keyed
    state takes to ship at ``config.state_transfer_rate`` — the shared
    formula behind the executor's pauses and the guard's lost-service
    term (one copy, so the guard can never disagree with the run)."""
    pause = np.where(transfer.migrated, config.migration_pause, 0).astype(np.int64)
    rate = config.state_transfer_rate
    if math.isfinite(rate) and rate > 0.0:
        extra = np.ceil(transfer.instance_state / (rate * window_s))
        pause = pause + np.where(
            transfer.migrated, extra.astype(np.int64), 0
        )
    return pause


class _Placement:
    """Flat per-task views of one ExecutionGraph on one cluster."""

    __slots__ = ("etg", "comp", "machine", "e", "met", "n_inst", "offsets")

    def __init__(self, etg: ExecutionGraph, cluster: Cluster):
        self.etg = etg
        self.comp = etg.task_component()
        self.machine = etg.task_machine()
        ttypes = etg.utg.component_types[self.comp]
        mtypes = cluster.machine_types[self.machine]
        self.e = cluster.profile.e[ttypes, mtypes]
        self.met = cluster.profile.met[ttypes, mtypes]
        self.n_inst = etg.n_instances
        self.offsets = etg.component_offsets()


class StreamExecutor:
    """Deterministic windowed event loop for one (topology, cluster, trace).

    Args:
      etg: the initial schedule to execute.
      cluster: the cluster (nominal capacities; the trace modulates them).
      trace: a ``TraceSpec`` (compiled here with ``seed``) or an already
        compiled ``CompiledTrace`` (its own seed wins).
      seed: compilation seed for stochastic trace events.
      config: event-loop constants (see ``RuntimeConfig``).
      background_load: optional (W, m) or (m,) load other occupants of the
        shared machines consume — subtracted (clipped at zero) from the
        trace's capacity grid each window, so both the service step and
        every controller observation see only the residual head room.
        This is how the multi-tenant runtime prices co-tenants.
    """

    def __init__(
        self,
        etg: ExecutionGraph,
        cluster: Cluster,
        trace: TraceSpec | CompiledTrace,
        seed: int = 0,
        config: RuntimeConfig | None = None,
        background_load: np.ndarray | None = None,
        recorder=None,
    ):
        self.cluster = cluster
        self.config = config or RuntimeConfig()
        # Observability: NULL_RECORDER makes every hook a no-op and keeps
        # the windowed loop bit-identical to the uninstrumented path.
        self.recorder = NULL_RECORDER if recorder is None else recorder
        self.trace = (
            trace
            if isinstance(trace, CompiledTrace)
            else trace.compile(cluster, seed, utg=etg.utg)
        )
        if self.trace.capacity.shape[1] != cluster.n_machines:
            raise ValueError("trace capacity grid does not match the cluster")
        if background_load is not None:
            bg = np.asarray(background_load, dtype=np.float64)
            if bg.ndim == 1:
                bg = np.broadcast_to(bg, self.trace.capacity.shape)
            if bg.shape != self.trace.capacity.shape:
                raise ValueError(
                    "background_load must be (m,) or match the trace's "
                    f"(W, m) capacity grid {self.trace.capacity.shape}"
                )
            self.trace = dataclasses.replace(
                self.trace,
                capacity=np.clip(self.trace.capacity - bg, 0.0, None),
            )
        keyed_edges = {kt.edge for kt in self.trace.keyed}
        want_edges = {g.edge for g in etg.utg.groupings}
        if keyed_edges != want_edges:
            raise ValueError(
                "compiled trace's keyed edges do not match the topology's "
                "fields groupings — compile the trace with utg=etg.utg"
            )
        self._initial_etg = etg
        self._skew_cache: dict[int, object] = {}

    # ------------------------------------------------------------- run

    def run(self, controller=None) -> RuntimeResult:
        """Execute the trace; optionally let ``controller`` replan between
        windows.

        ``controller`` is any object with an integer ``period`` attribute
        and an ``update(obs) -> ExecutionGraph | None`` method; it is
        consulted every ``period`` windows with a ``WindowObs`` (see
        ``controller.py``) and may return a new placement, which takes
        effect next window (migrated/new instances pause per the config).

        When the executor was constructed with a ``repro_torch.obs``
        ``TraceRecorder``, the run activates it (so closed-form dispatch
        decisions anywhere below land in its log) and emits window-clock
        events, back-pressure transitions, replan events and
        per-component throughput / queue high-water metrics. The recorder
        only appends to its own state: results and
        ``RuntimeResult.fingerprint()`` are bit-identical with or without
        it.
        """
        with self.recorder.activate():
            return self._run(controller)

    def _run(self, controller=None) -> RuntimeResult:
        from repro_torch.runtime_stream.controller import WindowObs

        cfg = self.config
        tr = self.trace
        dt = tr.window_s
        W = tr.n_windows
        m = self.cluster.n_machines
        utg = self._initial_etg.utg
        n = utg.n_components
        topo = utg.topo_order()
        sources = set(utg.sources)
        parents = [utg.parents(i) for i in range(n)]
        alpha = utg.alpha

        # Keyed routing state: per fields edge, the parent, destination,
        # per-window active-segment index and the segment realizations;
        # shuffle_parents keeps only the evenly-split in-edges (spout
        # injection is always even). With no fields groupings this leaves
        # the arrival path bit-identical to the even-split event loop.
        keyed: list[tuple[int, int, np.ndarray, list]] = []
        for kt in tr.keyed:
            keyed.append(
                (
                    kt.edge[0],
                    kt.edge[1],
                    kt.segment_indices(W),
                    [r for _, r in kt.segments],
                )
            )
        keyed_edge_set = {(p, i) for p, i, _, _ in keyed}
        shuffle_parents = [
            [p for p in parents[i] if (p, i) not in keyed_edge_set]
            for i in range(n)
        ]

        place = _Placement(self._initial_etg, self.cluster)
        backlog = np.zeros(place.comp.shape[0], dtype=np.float64)
        pause = np.zeros(place.comp.shape[0], dtype=np.int64)
        prev_out = np.zeros(n, dtype=np.float64)
        throttle = 1.0

        offered = tr.rates
        admitted = np.zeros(W)
        throughput = np.zeros(W)
        dropped = np.zeros(W)
        queue_total = np.zeros(W)
        queue_max = np.zeros(W)
        machine_util = np.zeros((W, m))
        throttle_log = np.zeros(W)
        migrations = np.zeros(W, dtype=np.int64)
        events: list[tuple[int, str]] = list(tr.events)
        bp_on = False

        rec = self.recorder
        obs_on = rec.enabled
        if obs_on:
            rec.event("run_start", cat="executor", windows=W, machines=m, trace=tr.name)
            comp_tuples = [
                rec.metrics.counter(f"executor.throughput.c{i}") for i in range(n)
            ]
            q_hwm = rec.metrics.gauge("executor.queue_max")
            dropped_ctr = rec.metrics.counter("executor.dropped_tuples")
            replan_ctr = rec.metrics.counter("executor.replans_applied")
            # Per-window values accumulate in a vector and flush to the
            # counters once after the loop — W*n Counter.add calls in the
            # hot loop would dominate recorder overhead.
            comp_acc = np.zeros(n, dtype=np.float64)

        for t in range(W):
            if obs_on:
                rec.set_window(t)
            cap = tr.capacity[t]
            r_adm = offered[t] * throttle

            # 1. Arrivals: one hop per window (spouts this window, bolts
            # from their parents' previous-window processed output).
            # Shuffle streams split evenly; each fields edge then adds its
            # keyed contribution at the active realization's hash shares.
            arr = np.zeros(n, dtype=np.float64)
            for i in topo:
                if i in sources:
                    arr[i] = r_adm
                else:
                    for p in shuffle_parents[i]:
                        arr[i] += alpha[p] * prev_out[p]
            arr_inst = arr[place.comp] / place.n_inst[place.comp]
            for p, i, seg_idx, segs in keyed:
                lo, hi = int(place.offsets[i]), int(place.offsets[i + 1])
                real = segs[seg_idx[t]]
                arr_inst[lo:hi] += (alpha[p] * prev_out[p]) * real.shares(hi - lo)
            backlog = backlog + arr_inst * dt
            over = np.clip(backlog - cfg.max_queue, 0.0, None)
            backlog = backlog - over
            dropped[t] = float(over.sum()) / dt

            # 2. Service under proportional fair machine throttling.
            active = (pause == 0).astype(np.float64)
            desired = backlog / dt * active
            var_w = per_machine_utilization(place.machine, place.e * desired, m)
            met_w = per_machine_utilization(place.machine, place.met * active, m)
            head = np.maximum(cap - met_w, 0.0)
            with np.errstate(divide="ignore", invalid="ignore"):
                s = np.where(var_w > head, head / np.maximum(var_w, 1e-300), 1.0)
            processed = desired * s[place.machine]
            backlog = np.maximum(backlog - processed * dt, 0.0)
            alive = (cap > 0.0).astype(np.float64)
            tcu = place.e * processed + place.met * active * alive[place.machine]

            # bincount == np.add.at bit-for-bit (sequential input-order
            # accumulation), minus the per-window ufunc dispatch cost.
            prev_out = np.bincount(place.comp, weights=processed, minlength=n)

            # 3. Metrics + spout back-pressure for the next window.
            admitted[t] = r_adm
            throughput[t] = float(processed.sum())
            queue_total[t] = float(backlog.sum())
            queue_max[t] = float(backlog.max()) if backlog.size else 0.0
            machine_util[t] = per_machine_utilization(place.machine, tcu, m)
            throttle_log[t] = throttle
            if obs_on:
                comp_acc += prev_out
            q_frac = queue_max[t] / cfg.max_queue
            if q_frac > cfg.bp_high:
                throttle = max(cfg.throttle_min, throttle * cfg.throttle_down)
                if not bp_on:
                    events.append((t, "backpressure_on"))
                    bp_on = True
                    if obs_on:
                        rec.event("backpressure_on", cat="executor")
            elif q_frac < cfg.bp_low:
                throttle = min(1.0, throttle * cfg.throttle_up)
                if bp_on and throttle >= 1.0:
                    events.append((t, "backpressure_off"))
                    bp_on = False
                    if obs_on:
                        rec.event("backpressure_off", cat="executor")
            pause = np.maximum(pause - 1, 0)

            # 4. Controller hook (takes effect from the next window).
            if controller is not None and (t + 1) % controller.period == 0 and t + 1 < W:
                notice = cfg.capacity_notice
                obs = WindowObs(
                    window=t,
                    window_s=dt,
                    etg=place.etg,
                    capacity=cap,
                    offered_rate=float(offered[t]),
                    throttle=float(throttle),
                    machine_util=machine_util[t],
                    queue_frac=float(q_frac),
                    queue_by_component=self._component_backlog(place, backlog),
                    throughput=float(throughput[t]),
                    skew=self.skew_model_at(t),
                    skew_epoch=tr.skew_epoch(t),
                    config=cfg,
                    capacity_ahead=(
                        tr.capacity[min(t + notice, W - 1)] if notice > 0 else None
                    ),
                )
                if obs_on:
                    with rec.span("controller.update", cat="controller"):
                        new_etg = controller.update(obs)
                else:
                    new_etg = controller.update(obs)
                if new_etg is not None:
                    transfer = placement_transfer(
                        place.etg, new_etg, skew=self.skew_model_at(t)
                    )
                    place, backlog, pause = self._migrate(
                        place, new_etg, backlog, transfer, t
                    )
                    migrations[t] = transfer.moves
                    events.append((t, f"replan:{transfer.moves}moves"))
                    if obs_on:
                        replan_ctr.add(1)
                        rec.event(
                            "replan_applied",
                            cat="executor",
                            moves=int(transfer.moves),
                            state_shipped=float(transfer.state_shipped),
                        )

        if obs_on:
            for i in range(n):
                comp_tuples[i].add(float(comp_acc[i]) * dt)
            if W:
                q_hwm.set(float(queue_max.max()))  # high-water mark
                q_hwm.set(float(queue_max[W - 1]))  # value = last window
            dropped_ctr.add(float(dropped.sum()) * dt)

        return RuntimeResult(
            name=tr.name,
            window_s=dt,
            offered=offered.copy(),
            admitted=admitted,
            throughput=throughput,
            dropped=dropped,
            queue_total=queue_total,
            queue_max=queue_max,
            machine_util=machine_util,
            throttle=throttle_log,
            migrations=migrations,
            events=tuple(events),
            final_etg=place.etg,
        )

    # ------------------------------------------------------------- skew

    def skew_model_at(self, window: int):
        """Skew-aware cost view of the active key realizations (cached per
        realization epoch; None for all-shuffle topologies). Controllers
        thread this into ``refine`` so replans score imbalanced placements
        with the realized per-instance load fractions."""
        if not self.trace.keyed:
            return None
        epoch = self.trace.skew_epoch(window)
        model = self._skew_cache.get(epoch)
        if model is None:
            from repro_torch.core.cost_model import SkewModel

            reals = self.trace.realizations_at(window)
            model = SkewModel(
                self._initial_etg.utg, {e: r.shares for e, r in reals.items()}
            )
            self._skew_cache[epoch] = model
        return model

    # ------------------------------------------------------- migration

    @staticmethod
    def _component_backlog(place: _Placement, backlog: np.ndarray) -> np.ndarray:
        return np.bincount(
            place.comp, weights=backlog, minlength=place.n_inst.shape[0]
        )

    def _migrate(
        self,
        place: _Placement,
        new_etg: ExecutionGraph,
        backlog: np.ndarray,
        transfer: MigrationTransfer,
        window: int,
    ) -> tuple[_Placement, np.ndarray, np.ndarray]:
        """Swap the live placement.

        A shuffle component's total backlog redistributes evenly over its
        new instances (shuffle regrouping on restart). A keyed component's
        in-flight tuples re-route *by key*: its backlog redistributes by
        the active realization's per-instance fractions
        (``SkewModel.instance_fractions`` — the same blend of even shuffle
        share and hash→instance key share every arrival uses), so a hot
        instance's queue stays hot across a replan instead of being
        laundered into an even split the routing immediately undoes.
        Restarting instances (``transfer.migrated``) pause for
        ``migration_pause`` windows plus their keyed state's transfer time
        (``transfer_pause_windows``) — a hot-key instance pauses longer
        than a cold one.
        """
        comp_backlog = self._component_backlog(place, backlog)
        new_place = _Placement(new_etg, self.cluster)
        new_backlog = (
            comp_backlog[new_place.comp] / new_place.n_inst[new_place.comp]
        )
        skew = self.skew_model_at(window)
        if skew is not None:
            offsets = new_etg.component_offsets()
            for c in skew.keyed_components:
                lo, hi = int(offsets[c]), int(offsets[c + 1])
                new_backlog[lo:hi] = comp_backlog[c] * skew.instance_fractions(
                    c, hi - lo
                )
        pause = transfer_pause_windows(transfer, self.config, self.trace.window_s)
        return new_place, new_backlog, pause
