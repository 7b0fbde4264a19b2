"""Online rescheduler: drift detection + incremental replanning.

``OnlineController`` watches the executor's windowed metrics and, when the
workload drifts away from the current schedule's sweet spot, re-plans
*incrementally*: instead of re-running the full scheduler from scratch it
hands the live placement to ``refine``'s delta-scored hill climb
(RELOCATE / SWAP / GROW / PAIRGROW / DROP on ``ScheduleState``), bounded to
a few moves per control period, against the cluster's *instantaneous*
capacity (``Cluster.with_capacity``). A replan is applied only when its
projected benefit clears a migration cost/benefit guard.

Drift triggers (any of):

* **capacity change** — the trace slowed or removed a machine since the
  last plan (reported as ``scale_out`` when a machine came *online* —
  a ``machine_addition`` column switching on);
* **drain notice** — a machine alive now is dead in the capacity
  lookahead (``WindowObs.capacity_ahead``): migrate off it *before* the
  capacity actually drops;
* **saturation** — the spout throttle is pinned below 1 or queues sit
  above the watermark (offered load exceeds what the placement sustains);
* **hot machine** — some alive machine's utilization crossed
  ``util_high`` of its capacity (the paper's over-utilization signal).

Cost/benefit guard: the projected gain is the closed-form throughput
improvement *capped by offered demand* (growing past what the trace offers
buys nothing), integrated over ``horizon_windows``, **minus the service the
migrated instances forgo while they sit in their migration pauses** (the
two-sided accounting: a replan that wins 2%/window but idles half the
pipeline for five windows is a loss at short horizons). The cost side is
*state-aware*: restarting instances charge ``migration_cost`` tuples each,
plus ``state_cost`` per keyed-state tuple they must ship
(``placement_transfer`` — hot-key instances ship more state, and their
longer transfer pauses also grow the forgone-service term through the
executor's own ``transfer_pause_windows`` formula). Plans that don't clear
the guard, or whose transfer cost exceeds ``elastic_budget``, are logged
and skipped. ``state_aware=False`` reverts to the flat
``moves × migration_cost`` pricing of the state-blind model — the
baseline the runtime benchmark compares against.

Elasticity: when the capacity grid *gains* a machine mid-trace
(``machine_addition`` — a column switching on) the drift reason is
``scale_out`` and the replan runs with the larger ``elastic_moves`` round
budget so growth chains can reach the new machine in one control period.
When the executor grants capacity notice
(``RuntimeConfig.capacity_notice`` > 0), a machine that is alive now but
dead in ``WindowObs.capacity_ahead`` triggers a ``drain``: the controller
plans against the *future* capacity (minimum of now and ahead), migrating
instances off the dying machine before its lease expires instead of
losing them with it.

``provision_schedule`` builds the "honest operator" baseline the
benchmarks freeze: Algorithm 1 + just enough Algorithm-2 growth to sustain
a target rate — the paper's protocol of sizing a schedule to the currently
observed load, which is exactly what rate drift then invalidates.

Both controllers take ``device=`` (default ``"cuda"``) and hand it to every
``refine`` they run: on a card each replan's candidate sweeps score through
the hand-written scorer (B1, or B2 with the cut-traffic kernel on a
resource cluster). The guard's single-placement scores stay on the host,
as in ``repro_torch.core``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import torch

from repro_torch import resolve_device
from repro_torch.core import cost_model
from repro_torch.core.first_assignment import first_assignment
from repro_torch.core.graph import ExecutionGraph, UserGraph
from repro_torch.core.profiles import Cluster
from repro_torch.core.refine import refine
from repro_torch.core.schedule_state import (
    ScheduleState,
    _grow_component_fast,
    _hottest_component,
)
from repro_torch.obs.ledger import ReplanDecision, ReplanLedger
from repro_torch.obs.trace import NULL_RECORDER

__all__ = [
    "WindowObs",
    "OnlineController",
    "OracleRescheduler",
    "provision_schedule",
]


@dataclasses.dataclass(frozen=True)
class WindowObs:
    """What the executor shows a controller at a control point."""

    window: int
    window_s: float
    etg: ExecutionGraph
    capacity: np.ndarray        # (m,) instantaneous per-machine capacity
    offered_rate: float         # trace rate this window
    throttle: float             # spout back-pressure throttle in effect
    machine_util: np.ndarray    # (m,) this window's utilization
    queue_frac: float           # deepest queue / max_queue
    queue_by_component: np.ndarray  # (n,) backlog per component
    throughput: float
    # Fields-grouping view (None / 0 on all-shuffle topologies): the active
    # key realizations as a cost_model.SkewModel, and a counter that bumps
    # at every key_skew_shift boundary.
    skew: "cost_model.SkewModel | None" = None
    skew_epoch: int = 0
    # Runtime config the executor runs under (pause/transfer-rate knobs the
    # guard needs to price migration downtime); None keeps legacy callers
    # working with flat defaults.
    config: "object | None" = None
    # (m,) capacity ``RuntimeConfig.capacity_notice`` windows ahead, or
    # None when no notice is granted — the scale-in (drain) lookahead.
    capacity_ahead: np.ndarray | None = None


def provision_schedule(
    utg: UserGraph, cluster: Cluster, rate: float, margin: float = 1.05
) -> ExecutionGraph:
    """Smallest-effort schedule sustaining ``rate`` (× ``margin``).

    Algorithm 1's minimal ETG, grown with Algorithm 2's hottest-component
    rule (the incremental engine's closed-form growth step) only until the
    closed-form R* covers the target — the paper's protocol of provisioning
    for the *currently observed* rate rather than the cluster's maximum.
    Returns the best-effort schedule even if the target is unreachable.
    """
    target = float(rate) * margin
    etg = first_assignment(utg, cluster, min(target, 1.0))
    state = ScheduleState.from_etg(etg, cluster)
    # Progressive scale-up toward the target (Algorithm 2's regime: grow at
    # moderate rates, not straight at the target — a single component's
    # chunks at a far-away rate may fit on no machine even though stepped
    # growth reaches it comfortably).
    step_rate = state.max_stable_rate()
    for _ in range(10_000):
        if step_rate >= target:
            break
        step_rate = min(max(step_rate * 1.25, target / 64.0), target)
        while state.max_stable_rate() < step_rate:
            util = state.utilization(step_rate)
            over = np.flatnonzero(cluster.capacity - util < 0.0)
            if over.size == 0:
                break
            component = _hottest_component(state, int(over[0]), step_rate)
            if _grow_component_fast(state, component, step_rate) == 0:
                return state.to_etg()  # saturated below the target: best effort
    return state.to_etg()


class OnlineController:
    """Windowed drift detector + guarded incremental rescheduler.

    Args:
      utg: the running topology.
      cluster: the nominal cluster (capacities are overridden per
        observation).
      period: control period in windows.
      max_moves: refine rounds per replan (each round applies one move, so
        this bounds migrations per control period).
      util_high: hot-machine trigger as a fraction of capacity.
      queue_high: queue-fraction trigger.
      migration_cost: tuples charged per migrated/new instance in the
        guard (restart downtime floor, state-independent).
      horizon_windows: windows the projected gain is assumed to persist
        (the guard's amortization horizon).
      state_aware: price migrations by the keyed state they actually ship
        (``placement_transfer`` with the observation's skew model) and
        subtract state-transfer pause downtime from the projected gain.
        ``False`` is the state-blind baseline: flat per-move pricing and
        flat one-window pauses, exactly the pre-state cost model.
      state_cost: guard tuples charged per state tuple shipped (the
        network/recovery price of a unit of keyed state).
      elastic_budget: hard cap on a single replan's transfer cost
        (``moves × migration_cost + state_shipped × state_cost``); plans
        above it are skipped regardless of benefit. ``inf`` disables.
      elastic_moves: refine round budget for ``scale_out``/``drain``
        replans (defaults to ``4 × max_moves``): growing onto a new
        machine or vacating a dying one routinely needs longer move
        chains than steady-state touch-ups.
      adaptive_growth: forward refine's depth-adaptive growth menu (lets a
        single replan grow a component past 4 instances when the closed
        form keeps improving — useful under fast rate ramps).
      measure_noise: when > 0, the controller observes machine utilization
        through the §6.2 measurement model instead of exactly: zero-mean
        Gaussian error with std ``measure_noise * cap_w * 4u(1-u)``
        (peaked at 50% load, truncated below the paper's observed 8% of
        capacity) is added to the drift detector's view. Only *detection*
        sees the noise — replans still score on the exact closed form,
        and the demand-capped cost/benefit guard is what keeps spurious
        triggers from churning the placement (tested no-churn at steady
        state).
      noise_seed: seed stream for the measurement noise (drawn per window,
        so runs stay deterministic).
      recorder: optional ``repro_torch.obs.TraceRecorder``; when enabled,
        every consult gets a span, every decision is mirrored into the
        recorder's record stream, and replans' ``refine`` calls emit
        per-round profiling spans. Decisions land in :attr:`ledger`
        either way — the recorder only adds the trace view.
      device: where replans' ``refine`` sweeps are scored — ``"cuda"``
        (default; raises without a card) or ``"cpu"``. Both give identical
        plans.

    Every decision point appends a structured
    ``ReplanDecision`` (trigger, candidate move list, the full
    two-sided guard breakdown, verdict) to :attr:`ledger`; the historical
    string log is the derived :attr:`log` view over it.
    """

    def __init__(
        self,
        utg: UserGraph,
        cluster: Cluster,
        period: int = 10,
        max_moves: int = 4,
        util_high: float = 0.92,
        queue_high: float = 0.25,
        migration_cost: float = 25.0,
        horizon_windows: int = 60,
        adaptive_growth: bool = False,
        measure_noise: float = 0.0,
        noise_seed: int = 0,
        state_aware: bool = True,
        state_cost: float = 1.0,
        elastic_budget: float = float("inf"),
        elastic_moves: int | None = None,
        recorder=None,
        device: str | torch.device = "cuda",
    ):
        self.utg = utg
        self.cluster = cluster
        self.period = int(period)
        self.max_moves = int(max_moves)
        self.util_high = float(util_high)
        self.queue_high = float(queue_high)
        self.migration_cost = float(migration_cost)
        self.horizon_windows = int(horizon_windows)
        self.adaptive_growth = bool(adaptive_growth)
        self.measure_noise = float(measure_noise)
        self.noise_seed = int(noise_seed)
        self.state_aware = bool(state_aware)
        self.state_cost = float(state_cost)
        self.elastic_budget = float(elastic_budget)
        self.elastic_moves = (
            4 * self.max_moves if elastic_moves is None else int(elastic_moves)
        )
        self._cir_sum = float(cost_model.component_rates(utg, 1.0).sum())
        self._last_capacity: np.ndarray | None = None
        self._last_skew_epoch: int | None = None
        self.recorder = NULL_RECORDER if recorder is None else recorder
        self.device = resolve_device(device)
        self.ledger = ReplanLedger()

    @property
    def log(self) -> list[tuple[int, str]]:
        """Legacy ``(window, message)`` view derived from :attr:`ledger`."""
        return self.ledger.legacy_view()

    def _decide(self, dec: ReplanDecision) -> None:
        """Append to the ledger and mirror into the recorder (if any)."""
        self.ledger.append(dec)
        rec = self.recorder
        if rec.enabled:
            rec.decision(dec)
            rec.metrics.counter(
                "controller.replans_accepted"
                if dec.accepted
                else "controller.replans_rejected"
            ).add(1)

    # ------------------------------------------------------------ drift

    def _observed_util(self, obs: WindowObs) -> np.ndarray:
        """The drift detector's view of machine utilization — exact, or
        perturbed by the §6.2 measurement model when ``measure_noise`` > 0
        (seeded per window: same run, same observations)."""
        if self.measure_noise <= 0.0:
            return obs.machine_util
        cap = np.where(obs.capacity > 0.0, obs.capacity, 1.0)
        u = np.clip(obs.machine_util / cap, 0.0, 1.0)
        # §6.2 shape scaled per machine: error is a fraction of *that
        # machine's* instantaneous capacity (the paper's 100-point budget
        # and <8-point truncation as capacity fractions), so slowed-down
        # machines aren't over-noised.
        std = self.measure_noise * cap * 4.0 * u * (1.0 - u)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.noise_seed, obs.window])
        )
        bound = 0.079 * cap
        noise = np.clip(rng.normal(0.0, 1.0, size=std.shape) * std, -bound, bound)
        return np.clip(obs.machine_util + noise, 0.0, None)

    def _drifted(self, obs: WindowObs) -> str | None:
        if self._last_capacity is not None and not np.array_equal(
            obs.capacity, self._last_capacity
        ):
            if np.any((self._last_capacity <= 0.0) & (obs.capacity > 0.0)):
                # A machine came online (machine_addition): elastic growth.
                return "scale_out"
            return "capacity"
        if obs.capacity_ahead is not None:
            dying = (obs.capacity > 0.0) & (np.asarray(obs.capacity_ahead) <= 0.0)
            if dying.any() and np.any(dying[obs.etg.task_machine()]):
                # Capacity notice: a machine hosting instances disappears
                # within the lookahead — drain it proactively instead of
                # losing its instances (and their state) when the column
                # actually drops.
                return "drain"
        if self._last_skew_epoch is not None and (
            obs.skew_epoch != self._last_skew_epoch
        ):
            # A key_skew_shift moved the hot keys: the placement was tuned
            # for the old realization even if nothing saturates yet.
            return "skew_shift"
        if obs.throttle < 1.0 or obs.queue_frac > self.queue_high:
            return "saturated"
        machine_util = self._observed_util(obs)
        alive = obs.capacity > 0.0
        if np.any(machine_util[alive] >= self.util_high * obs.capacity[alive]):
            return "hot"
        if obs.skew is not None and obs.queue_frac > 0.5 * self.queue_high:
            # Keyed blind spot: a single hot instance's queue is building
            # while every machine-average utilization still looks healthy
            # — the even-split signals above would wait for saturation.
            return "hot_instance"
        return None

    # ------------------------------------------------------- evacuation

    @staticmethod
    def _evacuate(etg: ExecutionGraph, cluster_t: Cluster, rate: float) -> ExecutionGraph:
        """Relocate every instance hosted on a capacity-0 machine.

        Thin wrapper over ``ScheduleState.evacuate_machines`` (the shared
        drain primitive): dead machines are drained greedily first because
        a hill climb scoring closed-form throughput cannot escape the
        0-throughput plateau when several instances sit on one, and
        ``refine`` polishes from there. Draining a machine under capacity
        notice is the same call against the lookahead capacity.
        """
        dead = cluster_t.capacity <= 0.0
        if not dead.any():
            return etg
        state = ScheduleState.from_etg(etg, cluster_t)
        state.evacuate_machines(dead, rate)
        return state.to_etg()

    # ----------------------------------------------------------- update

    def update(self, obs: WindowObs) -> ExecutionGraph | None:
        """Executor hook: returns a new placement or None to keep going."""
        from repro_torch.runtime_stream.executor import (
            RuntimeConfig,
            placement_transfer,
            transfer_pause_windows,
        )

        rec = self.recorder
        reason = self._drifted(obs)
        self._last_capacity = obs.capacity.copy()
        self._last_skew_epoch = obs.skew_epoch
        if rec.enabled:
            rec.metrics.counter("controller.drift_checks").add(1)
        if reason is None:
            return None
        if rec.enabled:
            rec.event("drift", cat="controller", trigger=reason)
        capacity = obs.capacity
        if obs.capacity_ahead is not None:
            # Plan against the *future* capacity whenever notice is
            # granted: a machine dying within the lookahead looks dead to
            # the planner, so the drain primitive vacates it (and no other
            # trigger's replan migrates back onto it while the notice
            # stands — that would be churn the removal immediately undoes).
            capacity = np.minimum(obs.capacity, np.asarray(obs.capacity_ahead))
        cluster_t = self.cluster.with_capacity(capacity)
        # Skew-aware scoring throughout: on keyed topologies both the
        # incumbent's worth and every replan candidate price per-instance
        # key shares, so a hot instance the even split cannot see is
        # exactly what the replan optimizes away.
        _, cur_thpt = cost_model.max_stable_rate(obs.etg, cluster_t, skew=obs.skew)
        base = self._evacuate(obs.etg, cluster_t, obs.offered_rate)
        rounds = (
            self.elastic_moves if reason in ("scale_out", "drain") else self.max_moves
        )
        plan = refine(
            base,
            cluster_t,
            max_rounds=rounds,
            adaptive_growth=self.adaptive_growth,
            skew=obs.skew,
            device=self.device,
            recorder=rec if rec.enabled else None,
        )
        # State-aware transfer pricing: which instances restart, and how
        # much keyed state each ships. The blind baseline prices the same
        # plan with skew=None — flat multiset moves, zero state.
        transfer = placement_transfer(
            obs.etg, plan.etg, skew=obs.skew if self.state_aware else None
        )
        if transfer.moves == 0:
            self._decide(
                ReplanDecision(
                    window=obs.window,
                    trigger=reason,
                    outcome="no_move",
                    candidate_moves=tuple(plan.moves),
                )
            )
            return None
        # Gain only materializes up to what the trace offers; the window
        # length comes from the observation (i.e. the executed trace), so
        # the guard's tuple arithmetic can never disagree with the run.
        demand = obs.offered_rate * self._cir_sum
        gain_rate = min(plan.throughput, demand) - min(cur_thpt, demand)
        benefit = gain_rate * self.horizon_windows * obs.window_s
        # Two-sided accounting: migrated instances serve nothing while
        # paused, and hot-key instances pause longer (state transfer), so
        # their forgone service comes off the projected gain — priced with
        # the executor's own pause formula so guard and run agree.
        cfg = obs.config if isinstance(obs.config, RuntimeConfig) else RuntimeConfig()
        pauses = transfer_pause_windows(transfer, cfg, obs.window_s)
        run_rate = min(obs.offered_rate, plan.rate)
        inst_ir = cost_model.instance_rates(plan.etg, run_rate, skew=obs.skew)
        pause_loss = float(
            (pauses * obs.window_s * inst_ir)[transfer.migrated].sum()
        )
        benefit -= pause_loss
        move_cost = transfer.moves * self.migration_cost
        state_cost = transfer.state_shipped * self.state_cost
        cost = move_cost + state_cost
        if rec.enabled:
            rec.metrics.counter("controller.guard_evals").add(1)
        if cost > self.elastic_budget:
            outcome = "budget"
        elif benefit <= cost:
            outcome = "skip"
        else:
            outcome = "replan"
        self._decide(
            ReplanDecision(
                window=obs.window,
                trigger=reason,
                outcome=outcome,
                moves=int(transfer.moves),
                state_shipped=float(transfer.state_shipped),
                gain_rate=float(gain_rate),
                benefit=float(benefit),
                pause_loss=pause_loss,
                move_cost=float(move_cost),
                state_cost=float(state_cost),
                cost=float(cost),
                budget=self.elastic_budget,
                demand=float(demand),
                current_throughput=float(cur_thpt),
                plan_throughput=float(plan.throughput),
                plan_rate=float(plan.rate),
                horizon_windows=self.horizon_windows,
                candidate_moves=tuple(plan.moves),
            )
        )
        if outcome != "replan":
            return None
        return plan.etg


class OracleRescheduler:
    """Upper-bound baseline: a full ``schedule()`` re-run at every window.

    No drift detection, no cost/benefit guard — the benchmark's oracle
    re-plans from scratch against every window's instantaneous capacity.
    Results are cached per *(capacity vector, skew epoch)*: ``schedule``
    is deterministic and rate-independent, but a ``key_skew_shift``
    changes which placement is best on a keyed topology even though the
    capacity grid is untouched — caching on capacity alone (the old bug)
    served a plan tuned for dead hot keys for the rest of the trace, which
    is how an "oracle" managed to lose to the online controller on keyed
    rows. On keyed topologies the cached plan is also polished skew-aware
    (``refine`` with the observation's skew model) so the oracle prices
    realized key shares, not the even split. Pair with
    ``RuntimeConfig(migration_pause=0)`` for the idealized free-migration
    oracle the runtime benchmark compares the controller against.
    """

    period = 1

    def __init__(
        self,
        utg: UserGraph,
        cluster: Cluster,
        rate_epsilon: float = 0.05,
        device: str | torch.device = "cuda",
    ):
        self.utg = utg
        self.cluster = cluster
        self.rate_epsilon = rate_epsilon
        self.device = resolve_device(device)
        self._cache: dict[tuple[bytes, int], ExecutionGraph] = {}

    def _current_polished(
        self, obs: WindowObs, alive: np.ndarray, sub: Cluster
    ) -> "object":
        """Skew-aware ``refine`` seeded from the *running* placement.

        Instances stranded on dead machines are drained first via the
        shared ``ScheduleState.evacuate_machines`` primitive, then machine
        indices are remapped onto the alive subcluster.
        """
        cluster_t = self.cluster.with_capacity(obs.capacity)
        etg = obs.etg
        dead = obs.capacity <= 0.0
        if dead[etg.task_machine()].any():
            state = ScheduleState.from_etg(etg, cluster_t)
            state.evacuate_machines(dead, obs.offered_rate)
            etg = state.to_etg()
        inv = np.full(obs.capacity.shape[0], -1, dtype=np.int64)
        inv[alive] = np.arange(alive.size)
        cur = ExecutionGraph(
            utg=self.utg,
            n_instances=etg.n_instances.copy(),
            assignment=[inv[a] for a in etg.assignment],
        )
        return refine(cur, sub, skew=obs.skew, device=self.device)

    def update(self, obs: WindowObs) -> ExecutionGraph | None:
        from repro_torch.core.maximize_throughput import schedule as _schedule

        key = (obs.capacity.tobytes(), obs.skew_epoch)
        alive = np.flatnonzero(obs.capacity > 0.0)
        if alive.size == 0:
            return None
        # Algorithm 1 assumes every machine is usable, so schedule on
        # the alive subcluster and map machine indices back.
        # ``subcluster`` carries the resource-vector fields (memory
        # capacities and the distance matrix restrict to the alive rows),
        # so the oracle optimizes the same generalized objective.
        sub = self.cluster.subcluster(alive, capacity=obs.capacity[alive])
        plan = self._cache.get(key)
        if plan is None:
            sub_plan = _schedule(
                self.utg, sub, r0=1.0, rate_epsilon=self.rate_epsilon
            ).etg
            if obs.skew is not None:
                # Skew-aware polish on the subcluster (key shares are
                # machine-agnostic, so the skew model carries over as-is).
                sub_plan = refine(sub_plan, sub, skew=obs.skew, device=self.device).etg
            plan = ExecutionGraph(
                utg=self.utg,
                n_instances=sub_plan.n_instances.copy(),
                assignment=[alive[a] for a in sub_plan.assignment],
            )
            self._cache[key] = plan
        if plan.task_machine().tolist() == obs.etg.task_machine().tolist():
            return None
        if obs.skew is not None:
            # Transition window (the plan differs from what is running).
            # Algorithm 1 sizes instances for the even split; under a
            # realized skew its instance counts can hash the hot keys
            # together — a local optimum ``refine`` cannot leave — and a
            # *cached* plan can predate a better placement the executor
            # has since reached. Seed a second polish from the running
            # placement and keep whichever scores the higher skew-aware
            # rate: a capacity or skew transition must never move the
            # oracle onto a worse plan than the one it already executes.
            # Steady-state windows short-circuit above, so this re-polish
            # runs only on the handful of transition windows per trace.
            polished = self._current_polished(obs, alive, sub)
            plan_sub = ExecutionGraph(
                utg=self.utg,
                n_instances=plan.n_instances.copy(),
                assignment=[
                    np.searchsorted(alive, a) for a in plan.assignment
                ],
            )
            plan_rate = refine(
                plan_sub, sub, max_rounds=0, skew=obs.skew, device=self.device
            ).rate
            if polished.rate > plan_rate:
                plan = ExecutionGraph(
                    utg=self.utg,
                    n_instances=polished.etg.n_instances.copy(),
                    assignment=[alive[a] for a in polished.etg.assignment],
                )
                self._cache[key] = plan
            if plan.task_machine().tolist() == obs.etg.task_machine().tolist():
                return None
        return plan
