"""Weighted max-min fair rate allocation across tenants (water filling).

The objective follows Ghaderi et al. (PAPERS.md): maximize the minimum
*fairness level* ``u_t = (R_t / R_target_t) / priority_t`` across tenants,
then the next minimum, and so on (leximin). The allocator is a round-robin
water-filling loop over the existing closed-form machinery:

* **fair-slice warm start** — every tenant is first scheduled solo on its
  proportional capacity slice ``f_t = priority_t * target_t / sum_s
  priority_s * target_s`` (the weighted fair share). The slices partition
  the capacity, so the ensemble of accepted warm-start placements is
  feasible on the shared cluster and each tenant opens at its fair-slice
  solo rate — the *solo-no-regression* guarantee holds by construction,
  because committed rates only ever increase from here. A slice can be
  too thin to host even one instance per component (MET is lumpy: an
  instance's fixed overhead cannot be fractionally spread, so at large N
  a 1%-of-each-machine slice may not fit it anywhere); such a tenant's
  fair-slice solo rate is exactly 0, and it instead *defers* to a minimal
  placement on the ensemble residual at rate 0 — no-regression stays
  trivially true and the water loop serves these level-0 tenants first.
  Accepted tenants then re-slice the MET-reduced capacity (fixpoint, at
  most N iterations), so the ensemble stays feasible by construction;
* each round picks the active tenant with the lowest level (canonical
  name-order tie-break) and raises its rate toward the closed-form
  residual R* — the exact maximum the shared cluster supports given every
  other tenant's committed load (priced through the shared-load view in
  ``MultiTenantState``);
* a tenant blocked at its residual R* spends one of its bounded
  ``structure_attempts`` on *structural* moves: a single-tenant
  ``refine`` pass on its residual cluster (RELOCATE / SWAP / GROW —
  other tenants' committed loads are baked into the residual capacity,
  so no move can evict a neighbour below its share), then a guarded
  **cross-tenant relocation** that shifts another tenant's instance off
  the blocked tenant's binding machine, batch-scored through
  ``TenantBatchScorer`` and accepted only if *every* tenant's committed
  rate stays feasible;
* a tenant blocked with no structural escape (or out of attempts) is
  deactivated with its rate committed. Committed rates never degrade
  afterwards: every later raise is capped by a residual that already
  prices the committed load, and every relocation re-checks all tenants
  before applying.

Levels fill in near-lockstep (``level_step`` bounds how far one tenant may
overshoot the pack), approximating leximin while reusing the single-tenant
engines unchanged. ``N == 1`` short-circuits to the stock
``schedule() + refine()`` pipeline and is bit-identical to it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.first_assignment import first_assignment
from repro_torch.core.graph import ExecutionGraph
from repro_torch.core.maximize_throughput import schedule
from repro_torch.core.profiles import Cluster
from repro_torch.core.refine import refine
from repro_torch.core.schedule_state import ScheduleState

from repro_torch.multitenant.batch import TenantBatchScorer
from repro_torch.multitenant.state import MultiTenantState
from repro_torch.multitenant.tenants import Tenant, TenantSet

__all__ = [
    "TenantAllocation",
    "MultiTenantSchedule",
    "fair_shares",
    "fair_slice_floors",
    "schedule_tenants",
]

# Relative slack when checking a committed rate is still feasible after a
# structural move (absorbs last-ulp drift of the residual closed form).
_COMMIT_SLACK = 1e-9

# Relative back-off applied to warm-start rates. A solo refine rate makes
# its binding machine's load touch the slice capacity *exactly*, so N
# tenants' warm loads would sum to capacity up to accumulated rounding —
# and any machine landing a few ulps over collapses closed-form residuals
# to zero. Backing each warm rate off by 1e-9 leaves ~1e-7 absolute head
# room per machine, orders of magnitude above the accumulation error,
# while costing a relative 1e-9 of rate (recoverable by the water loop).
_WARM_BACKOFF = 1e-9


@dataclasses.dataclass(frozen=True)
class TenantAllocation:
    """One tenant's share of the shared cluster."""

    name: str
    etg: ExecutionGraph
    rate: float
    target_rate: float
    priority: float

    @property
    def satisfaction(self) -> float:
        """Allocated over contracted rate, ``R / R_target``."""
        return self.rate / self.target_rate

    @property
    def level(self) -> float:
        """Weighted fairness level ``satisfaction / priority``."""
        return self.satisfaction / self.priority


@dataclasses.dataclass(frozen=True)
class MultiTenantSchedule:
    """Fairness allocation for a tenant set (reported in submission order)."""

    allocations: tuple[TenantAllocation, ...]
    rounds: int
    candidates_evaluated: int
    log: tuple[str, ...]

    def allocation(self, name: str) -> TenantAllocation:
        for a in self.allocations:
            if a.name == name:
                return a
        raise KeyError(name)

    @property
    def rates(self) -> np.ndarray:
        return np.array([a.rate for a in self.allocations], dtype=np.float64)

    @property
    def levels(self) -> np.ndarray:
        return np.array([a.level for a in self.allocations], dtype=np.float64)

    @property
    def min_level(self) -> float:
        return float(self.levels.min())


def fair_shares(tenants: "TenantSet | list[Tenant]") -> np.ndarray:
    """(N,) weighted fair capacity share per tenant (submission order):
    ``f_t = priority_t * target_t / sum_s priority_s * target_s``.

    The denominator sums in canonical (name) order so shares — and
    everything warm-started from them — are bit-identical under tenant
    submission-order permutations.
    """
    tset = tenants if isinstance(tenants, TenantSet) else TenantSet(tenants)
    scales = np.array([t.level_scale for t in tset], dtype=np.float64)
    denom = 0.0
    for i in tset.canonical_order():
        denom += float(scales[i])
    return scales / denom


def fair_slice_floors(
    tenants: "TenantSet | list[Tenant]",
    cluster: Cluster,
    *,
    warm_refine_rounds: int = 200,
    device: str | torch.device = "cuda",
    solo_rate_epsilon: float = 0.5,
) -> np.ndarray:
    """(N,) guaranteed rate floor per tenant (submission order).

    This is exactly the warm-start baseline ``schedule_tenants`` opens
    from: each tenant's solo rate on its fair slice of the MET-reduced
    working capacity (0.0 for tenants whose slice cannot host their
    rate-0 load — see ``_warm_start``). The water loop only raises rates,
    so ``schedule_tenants(...)`` with the same budgets allocates every
    tenant at least this floor — the solo-no-regression guarantee, in a
    form benchmarks and tests can recompute independently.
    """
    tset = tenants if isinstance(tenants, TenantSet) else TenantSet(tenants)
    device = resolve_device(device)
    _, rates = _warm_start(
        tset,
        cluster,
        tset.canonical_order(),
        warm_refine_rounds=warm_refine_rounds,
        device=device,
        solo_rate_epsilon=solo_rate_epsilon,
    )
    return rates


def schedule_tenants(
    tenants: "TenantSet | list[Tenant]",
    cluster: Cluster,
    *,
    warm_start: bool = True,
    warm_refine_rounds: int = 200,
    level_step: float = 0.25,
    rate_tol: float = 1e-6,
    refine_moves: int = 2,
    structure_attempts: int = 4,
    cross_tenant_moves: bool = True,
    max_rounds: int = 10_000,
    device: str | torch.device = "cuda",
    solo_rate_epsilon: float = 0.5,
    validate: bool = False,
) -> MultiTenantSchedule:
    """Weighted max-min fair schedule of N tenants on one shared cluster.

    Args:
      tenants: the tenant set (or a plain list; names must be unique).
      cluster: the shared heterogeneous cluster.
      warm_start: open every tenant at its fair-slice solo schedule (the
        solo-no-regression guarantee); disable only for experiments.
      warm_refine_rounds: refine budget for each warm-start solo run
        (200 = the single-tenant default; lower it for large fleets).
      level_step: how far (in fairness-level units) the lowest tenant may
        raise past the pack when every active tenant is level; smaller
        values track leximin tighter at more rounds.
      rate_tol: minimum rate progress per raise; also the blocked test.
      refine_moves: ``max_rounds`` handed to the per-tenant residual
        ``refine`` pass when a tenant is blocked (0 disables it).
      structure_attempts: structural-escape budget per tenant (each
        blocked round spends one on refine + cross-tenant relocation);
        bounds worst-case run time on saturated clusters.
      cross_tenant_moves: enable the guarded cross-tenant relocation.
      max_rounds: hard backstop on water-filling rounds.
      device: where every batched sweep is scored — the warm starts' and
        structural escapes' ``refine`` and the tenant-batched relocation
        guard: ``"cuda"`` (default: the hand-written scorer; raises
        without a card) or ``"cpu"`` (its plain PyTorch version). Both
        give the same allocation.
      solo_rate_epsilon: ``rate_epsilon`` for every solo ``schedule()``
        call (warm starts and the N == 1 fast path).
      validate: re-check the shared-load invariant after every round
        (O(N·m) per round; property tests turn this on).

    Returns:
      ``MultiTenantSchedule`` with per-tenant allocations in submission
      order, the round count, and the number of candidate rows scored
      through the tenant-batched path.
    """
    tset = tenants if isinstance(tenants, TenantSet) else TenantSet(tenants)
    device = resolve_device(device)

    if len(tset) == 1:
        return _solo_schedule(tset, cluster, device, solo_rate_epsilon)

    canonical = tset.canonical_order()
    scales = np.array([t.level_scale for t in tset], dtype=np.float64)

    if warm_start:
        states, rates = _warm_start(
            tset,
            cluster,
            canonical,
            warm_refine_rounds=warm_refine_rounds,
            device=device,
            solo_rate_epsilon=solo_rate_epsilon,
        )
        mt = MultiTenantState(tset, cluster, states, rates=rates)
        met_total = np.zeros(cluster.n_machines, dtype=np.float64)
        for i in canonical:
            met_total += states[i].met_load
        if np.any(met_total > cluster.capacity * (1.0 + _COMMIT_SLACK)):
            worst = float((met_total - cluster.capacity).max())
            raise ValueError(
                "cluster cannot host tenant set: fixed MET load alone "
                f"exceeds capacity (worst machine overshoot {worst:.3g} "
                "points) — add machines or reduce the fleet"
            )
    else:
        mt = MultiTenantState.first_assignment(tset, cluster)

    active = [True] * len(tset)
    attempts = [structure_attempts] * len(tset)
    log: list[str] = []
    candidates = 0
    rounds = 0
    cap = cluster.capacity
    # Incrementally maintained total machine load: a rate raise is an O(m)
    # delta; structural moves trigger a full refresh.
    total = mt.total_load()

    while any(active) and rounds < max_rounds:
        rounds += 1
        levels = mt.rates / scales
        # min() keeps the first minimum, and we iterate in canonical name
        # order — so level ties break canonically, independent of
        # submission order.
        t = min((i for i in canonical if active[i]), key=lambda i: levels[i])
        st_t = mt.states[t]
        head = cap - (total - mt.load_of(t)) - st_t.met_load
        var = st_t.var_load
        # Same masking as MultiTenantState.residual_rstar: machines the
        # tenant doesn't touch can't constrain it (ulp-negative residuals
        # on fully packed machines are the co-tenants' business).
        if np.any((head < 0.0) & ((st_t.met_load > 0.0) | (var > 0.0))):
            r_star = 0.0
        else:
            with np.errstate(divide="ignore"):
                lims = np.where(var > 0.0, head / np.maximum(var, 1e-300), np.inf)
            r_star = float(max(np.min(lims), 0.0))

        higher = [
            levels[s]
            for s in range(len(tset))
            if active[s] and levels[s] > levels[t] + 1e-12
        ]
        goal_level = min(higher) if higher else levels[t] + level_step
        new_rate = min(r_star, goal_level * scales[t])

        if new_rate > mt.rates[t] + rate_tol:
            total += (new_rate - float(mt.rates[t])) * var
            mt.rates[t] = new_rate
            continue

        # Blocked at residual R*: structural escapes while budget lasts.
        improved = False
        if attempts[t] > 0:
            attempts[t] -= 1
            if refine_moves > 0:
                improved = _refine_on_residual(
                    mt, tset, t, r_star, refine_moves, rate_tol, device
                )
                if improved:
                    log.append(f"round {rounds}: refine improved tenant {tset[t].name}")
            if not improved and cross_tenant_moves:
                improved, scored = _cross_tenant_relocate(
                    mt, tset, t, r_star, rate_tol, device
                )
                candidates += scored
                if improved:
                    log.append(f"round {rounds}: cross-tenant move for {tset[t].name}")
        if improved:
            total = mt.total_load()
        else:
            # Take any sub-tolerance head room left, then commit.
            commit = max(float(mt.rates[t]), float(new_rate))
            total += (commit - float(mt.rates[t])) * var
            mt.rates[t] = commit
            active[t] = False
            log.append(
                f"round {rounds}: tenant {tset[t].name} committed at "
                f"rate {mt.rates[t]:.6g} (level {levels[t]:.4g})"
            )
        if validate and not mt.feasible(slack=1e-9):
            over = float((mt.total_load() - cap).max())
            raise AssertionError(
                f"round {rounds} (tenant {tset[t].name}): shared-load "
                f"invariant violated by {over:.3e}"
            )

    # Final verification: the shared-load invariant (total linear load
    # within capacity) plus one tenant-batched sweep scoring every
    # tenant's incumbent row — the batched path must agree that each
    # committed rate fits its residual wherever the closed form is not on
    # its infeasibility cliff (a fully packed machine a few ulps over
    # collapses residual R* to 0; the direct invariant is the robust
    # check there).
    if not mt.feasible(slack=1e-9):
        over = mt.total_load() - cluster.capacity
        raise AssertionError(
            f"shared-load invariant violated: worst overshoot {over.max():.3e}"
        )
    scorer = TenantBatchScorer(mt, device=device)
    resid = scorer.residual_rates()
    candidates += scorer.candidates_evaluated
    for i in range(len(tset)):
        if resid[i] > 0.0 and mt.rates[i] > resid[i] * (1.0 + _COMMIT_SLACK) + rate_tol:
            raise AssertionError(
                f"tenant {tset[i].name}: committed rate {mt.rates[i]} exceeds "
                f"residual R* {resid[i]}"
            )

    allocations = tuple(
        TenantAllocation(
            name=tset[i].name,
            etg=mt.states[i].to_etg(),
            rate=float(mt.rates[i]),
            target_rate=tset[i].target_rate,
            priority=tset[i].priority,
        )
        for i in range(len(tset))
    )
    return MultiTenantSchedule(
        allocations=allocations,
        rounds=rounds,
        candidates_evaluated=candidates,
        log=tuple(log),
    )


def _warm_start(
    tset: TenantSet,
    cluster: Cluster,
    canonical: "list[int]",
    *,
    warm_refine_rounds: int,
    device,
    solo_rate_epsilon: float,
) -> "tuple[list[ScheduleState], np.ndarray]":
    """Fair-slice warm start with MET-aware deferral, to a fixpoint.

    Each tenant schedules solo on its share of the *working* capacity. A
    tenant whose slice cannot host even its rate-0 load (MET is lumpy — a
    sub-MET slice fits no instance anywhere) is **deferred**: it gets a
    minimal placement on the ensemble residual at rate 0, and its fixed
    MET is subtracted from the working capacity the remaining tenants
    slice up. Accepted tenants whose warm load no longer fits the shrunk
    slice re-run; the loop repeats until no new tenant defers (the
    deferred set grows monotonically, so at most N iterations).

    On exit the ensemble is feasible by construction: accepted loads sum
    to at most the working capacity (slices partition it) and the working
    capacity already excludes every deferred MET. When deferral occurs the
    solo-no-regression guarantee is stated against the MET-reduced
    capacity — the deferred tenants' own fair-slice baselines are exactly
    0, so theirs holds trivially.
    """
    shares = fair_shares(tset)
    n = len(tset)
    m = cluster.n_machines
    work_cap = cluster.capacity.astype(np.float64).copy()
    states: list[ScheduleState | None] = [None] * n
    rates = np.zeros(n, dtype=np.float64)
    deferred: set[int] = set()

    # Cheap deferral pre-check: component c of tenant i can never be
    # placed inside a slice whose capacity is below met[c, w] on every
    # machine — skip the wasted solo run and defer straight away.
    met_tables = [
        cluster.met_for(tset[i].utg.component_types) for i in range(n)
    ]

    while True:
        load_sum = np.zeros(m, dtype=np.float64)
        new_deferred: list[int] = []
        for i in canonical:
            if i in deferred:
                continue
            tenant = tset[i]
            slice_cap = work_cap * shares[i]
            if bool(np.any(np.all(met_tables[i] > slice_cap + 1e-9, axis=1))):
                new_deferred.append(i)
                continue
            st = states[i]
            if st is not None:
                # Prior iteration's warm placement still fits the shrunk
                # slice — keep it (deterministic, and saves a solo run).
                warm_load = st.met_load + rates[i] * st.var_load
                if np.all(warm_load <= slice_cap + 1e-9):
                    load_sum += warm_load
                    continue
            sliced = cluster.with_capacity(slice_cap)
            sched = schedule(tenant.utg, sliced, r0=1.0, rate_epsilon=solo_rate_epsilon)
            ref = refine(
                sched.etg,
                sliced,
                max_rounds=warm_refine_rounds,
                device=device,
                skew=tenant.skew,
            )
            st = ScheduleState.from_etg(ref.etg, cluster, skew=tenant.skew)
            rate = ref.rate * (1.0 - _WARM_BACKOFF)
            warm_load = st.met_load + rate * st.var_load
            if np.all(warm_load <= slice_cap + 1e-9):
                states[i] = st
                rates[i] = rate
                load_sum += warm_load
            else:
                new_deferred.append(i)
        if not new_deferred:
            break
        for i in new_deferred:
            tenant = tset[i]
            residual = work_cap - load_sum
            etg = first_assignment(tenant.utg, cluster.with_capacity(residual), r0=1.0)
            st = ScheduleState.from_etg(etg, cluster, skew=tenant.skew)
            states[i] = st
            rates[i] = 0.0
            deferred.add(i)
            work_cap = work_cap - st.met_load

    return [st for st in states], rates  # type: ignore[return-value]


def _solo_schedule(
    tset: TenantSet, cluster: Cluster, device, rate_epsilon: float
) -> MultiTenantSchedule:
    """N == 1: the stock single-tenant pipeline, bit-identical."""
    tenant = tset[0]
    sched = schedule(tenant.utg, cluster, r0=1.0, rate_epsilon=rate_epsilon)
    ref = refine(sched.etg, cluster, device=device, skew=tenant.skew)
    alloc = TenantAllocation(
        name=tenant.name,
        etg=ref.etg,
        rate=float(ref.rate),
        target_rate=tenant.target_rate,
        priority=tenant.priority,
    )
    return MultiTenantSchedule(
        allocations=(alloc,), rounds=0, candidates_evaluated=0, log=()
    )


def _refine_on_residual(
    mt: MultiTenantState,
    tset: TenantSet,
    t: int,
    r_star: float,
    refine_moves: int,
    rate_tol: float,
    device,
) -> bool:
    """Single-tenant refine pass on tenant ``t``'s residual cluster.

    The residual capacity already subtracts every other tenant's committed
    load, so any placement refine admits is feasible for the ensemble by
    construction. Accepted only on strict rate improvement.
    """
    own_load = mt.load_of(t)
    residual = np.maximum(mt.residual_capacity(t), own_load)
    ref = refine(
        mt.states[t].to_etg(),
        mt.cluster.with_capacity(residual),
        max_rounds=refine_moves,
        device=device,
        skew=tset[t].skew,
    )
    if ref.rate > r_star + rate_tol:
        mt.replace_state(
            t, ScheduleState.from_etg(ref.etg, mt.cluster, skew=tset[t].skew)
        )
        return True
    return False


def _cross_tenant_relocate(
    mt: MultiTenantState,
    tset: TenantSet,
    t: int,
    r_star: float,
    rate_tol: float,
    device,
    max_tries: int = 8,
) -> tuple[bool, int]:
    """Move another tenant's instance off tenant ``t``'s binding machine.

    Enumerates one candidate per (tenant s != t, component with instances
    on the binding machine, destination machine); every candidate's
    donor-feasibility guard is batch-scored in ONE ``TenantBatchScorer``
    call (rows of different tenants in one kernel launch). Candidates that
    keep the donor at its committed rate are ranked by tenant ``t``'s
    closed-form improvement; the best is applied only if a full post-check
    shows every tenant's committed rate still fits its residual — one
    tenant's escape can never push another below its share.

    Returns (applied, candidate_rows_scored).
    """
    st_t = mt.states[t]
    head = mt.residual_capacity(t) - st_t.met_load
    var = st_t.var_load
    with np.errstate(divide="ignore", invalid="ignore"):
        limits = np.where(var > 0.0, head / np.maximum(var, 1e-300), np.inf)
    w_star = int(np.argmin(limits))

    # Enumerate donor candidates in canonical order (determinism).
    scorer = TenantBatchScorer(mt, device=device)
    sweeps: list[tuple[int, np.ndarray]] = []
    meta: list[tuple[int, int, int, int]] = []  # (s, comp, k, dest)
    m = mt.cluster.n_machines
    for s in tset.canonical_order():
        if s == t:
            continue
        st_s = mt.states[s]
        base_s = st_s.task_machine()
        offs = st_s.component_offsets()
        rows_s = []
        for c in range(st_s.utg.n_components):
            if st_s.comp_counts[c, w_star] <= 0:
                continue
            k = st_s.assignment[c].index(w_star)
            col = int(offs[c]) + k
            for dest in range(m):
                if dest == w_star:
                    continue
                row = base_s.copy()
                row[col] = dest
                rows_s.append(row)
                meta.append((s, c, k, dest))
        if rows_s:
            sweeps.append((s, np.stack(rows_s)))
    if not meta:
        return False, 0

    scored = scorer.score(sweeps)
    donor_rates = np.concatenate([r for r, _ in scored])
    n_scored = int(donor_rates.shape[0])

    # Rank guard-passing candidates by t's closed-form gain.
    gains: list[tuple[float, int]] = []
    for idx, (s, c, k, dest) in enumerate(meta):
        if donor_rates[idx] < mt.rates[s] * (1.0 - _COMMIT_SLACK) - rate_tol:
            continue
        st_s = mt.states[s]
        unit = _instance_unit_ir(st_s, c, k)
        load_src = st_s.met_cm[c, w_star] + st_s.e_cm[c, w_star] * unit * mt.rates[s]
        load_dst = st_s.met_cm[c, dest] + st_s.e_cm[c, dest] * unit * mt.rates[s]
        delta = np.zeros(m)
        delta[w_star] = load_src
        delta[dest] = -load_dst
        with np.errstate(divide="ignore", invalid="ignore"):
            lims = np.where(var > 0.0, (head + delta) / np.maximum(var, 1e-300), np.inf)
        gains.append((float(np.min(lims)), idx))
    gains.sort(key=lambda g: (-g[0], g[1]))

    for gain, idx in gains[:max_tries]:
        if gain <= r_star + rate_tol:
            break
        s, c, k, dest = meta[idx]
        st_s = mt.states[s]
        st_s.relocate_instance(c, k, dest)
        if all(
            mt.residual_rstar(v) >= mt.rates[v] * (1.0 - _COMMIT_SLACK) - rate_tol
            for v in range(len(tset))
        ):
            return True, n_scored
        st_s.relocate_instance(c, k, w_star)  # revert
    return False, n_scored


def _instance_unit_ir(st: ScheduleState, c: int, k: int) -> float:
    """Unit-rate input rate of instance (c, k) — skew-aware."""
    if st.skew is not None:
        frac = st.skew.instance_fractions(c, int(st.n_instances[c]))
        if frac is not None:
            return float(st.cir_unit[c] * frac[k])
    return float(st.cir_unit[c] / int(st.n_instances[c]))
