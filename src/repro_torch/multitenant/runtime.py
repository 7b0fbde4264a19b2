"""Multi-tenant extension of the streaming runtime.

Each tenant runs its own trace-driven event loop, but all loops share one
cluster: tenant t's executor sees the shared capacity grid minus every
co-tenant's *planned* load (linear model at the co-tenant's allocated
rate, demand-capped by its offered trace), via
``StreamExecutor(background_load=...)``. Controller observations therefore
carry residual capacities, so a tenant's replans are priced against the
head room that is actually its to use — a failure or skew replan cannot
claim capacity a neighbour's allocation owns.

Cross-tenant replan arbitration is a shared ``ReplanArbiter`` ledger:
every tenant's ``OnlineController`` is wrapped so its migrations draw from
a fixed per-tenant budget per control period. One tenant thrashing through
drift events exhausts only its own budget; the others keep replanning.

``compile_tenant_traces`` compiles one ``TraceSpec`` per tenant onto a
single shared capacity grid (machine slowdowns and failures are cluster
events — every tenant must see the same machines).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.profiles import Cluster
from repro_torch.core.schedule_state import ScheduleState
from repro_torch.obs.ledger import ReplanDecision
from repro_torch.obs.trace import NULL_RECORDER

from repro_torch.runtime_stream.controller import OnlineController
from repro_torch.runtime_stream.executor import (
    RuntimeConfig,
    RuntimeResult,
    StreamExecutor,
    placement_migrations,
)
from repro_torch.runtime_stream.traces import CompiledTrace, TraceSpec

from repro_torch.multitenant.fairness import MultiTenantSchedule
from repro_torch.multitenant.tenants import TenantSet

__all__ = [
    "MultiTenantTrace",
    "compile_tenant_traces",
    "ReplanArbiter",
    "TenantArbiterLedger",
    "MultiTenantRuntime",
    "MultiTenantRuntimeResult",
]


@dataclasses.dataclass(frozen=True)
class MultiTenantTrace:
    """Per-tenant compiled traces on one shared capacity grid."""

    names: tuple[str, ...]
    traces: tuple[CompiledTrace, ...]
    capacity: np.ndarray  # (W, m) — shared by every tenant

    @property
    def n_windows(self) -> int:
        return int(self.capacity.shape[0])

    @property
    def window_s(self) -> float:
        return float(self.traces[0].window_s)

    def trace_for(self, name: str) -> CompiledTrace:
        return self.traces[self.names.index(name)]


def compile_tenant_traces(
    tenants: TenantSet,
    specs: "list[TraceSpec]",
    cluster: Cluster,
    seed: int = 0,
    capacity_spec: "TraceSpec | None" = None,
) -> MultiTenantTrace:
    """Compile one spec per tenant onto a single shared capacity grid.

    Each tenant's spec compiles with an independent child seed (so rate
    noise / keyed realizations decorrelate across tenants) and with its
    own topology (keyed edges). Capacity events — slowdowns, failures —
    live in ``capacity_spec`` (default: the nominal flat grid): machines
    are shared, so every tenant must observe the same capacity trajectory;
    per-tenant capacity events in ``specs`` are rejected.
    """
    if len(specs) != len(tenants):
        raise ValueError("one TraceSpec per tenant required")
    horizon = {(s.n_windows, getattr(s, "window_s", None)) for s in specs}
    if len({s.n_windows for s in specs}) != 1:
        raise ValueError("tenant traces must share one horizon (n_windows)")
    del horizon

    if capacity_spec is None:
        cap_grid = np.broadcast_to(
            cluster.capacity, (specs[0].n_windows, cluster.n_machines)
        ).astype(np.float64)
    else:
        if capacity_spec.n_windows != specs[0].n_windows:
            raise ValueError("capacity_spec horizon must match tenant specs")
        cap_grid = capacity_spec.compile(cluster, seed).capacity

    traces = []
    for i, (tenant, spec) in enumerate(zip(tenants, specs)):
        child_seed = int(np.random.SeedSequence([seed, i]).generate_state(1)[0])
        compiled = spec.compile(cluster, child_seed, utg=tenant.utg)
        if not np.array_equal(
            compiled.capacity,
            np.broadcast_to(cluster.capacity, compiled.capacity.shape),
        ):
            raise ValueError(
                f"tenant {tenant.name!r} spec carries capacity events — put "
                "machine slowdowns/failures in capacity_spec (shared machines)"
            )
        traces.append(dataclasses.replace(compiled, capacity=cap_grid.copy()))
    return MultiTenantTrace(
        names=tuple(t.name for t in tenants),
        traces=tuple(traces),
        capacity=cap_grid,
    )


@dataclasses.dataclass(frozen=True)
class TenantArbiterLedger:
    """One tenant's view of the shared ``ReplanArbiter`` ledger.

    ``budget_remaining`` lists, per control period the tenant actually
    requested admission in, the moves left of its ``moves_per_period``
    budget after all admissions in that period.
    """

    name: str
    grants: int
    denials: int
    moves_admitted: int
    moves_denied: int
    moves_per_period: int
    budget_remaining: tuple[tuple[int, int], ...]  # (period index, moves left)


class ReplanArbiter:
    """Shared migration-budget ledger across tenants' controllers.

    Each tenant may migrate at most ``moves_per_period`` instances per
    control period. Budgets are strictly per tenant, so no admission by
    one tenant can ever reduce another's — the starvation guard is by
    construction, not by scheduling order.
    """

    def __init__(self, moves_per_period: int = 8, recorder=None):
        self.moves_per_period = int(moves_per_period)
        self.recorder = NULL_RECORDER if recorder is None else recorder
        self._used: dict[tuple[str, int], int] = {}
        self.log: list[tuple[str, int, int, bool]] = []  # (tenant, window, moves, admitted)

    def admit(self, tenant: str, window: int, period: int, moves: int) -> bool:
        bucket = (tenant, window // max(period, 1))
        used = self._used.get(bucket, 0)
        ok = used + moves <= self.moves_per_period
        if ok:
            self._used[bucket] = used + moves
        self.log.append((tenant, int(window), int(moves), ok))
        rec = self.recorder
        if rec.enabled:
            rec.metrics.counter(
                "arbiter.grants" if ok else "arbiter.denials"
            ).add(1)
            rec.event(
                "arbiter_grant" if ok else "arbiter_denial",
                cat="arbiter",
                tenant=tenant,
                moves=int(moves),
                remaining=self.moves_per_period - self._used.get(bucket, used),
            )
        return ok

    def tenant_summary(self, tenant: str) -> TenantArbiterLedger:
        """Roll this tenant's ledger rows up into a ``TenantArbiterLedger``."""
        grants = denials = admitted = denied = 0
        for name, _w, moves, ok in self.log:
            if name != tenant:
                continue
            if ok:
                grants += 1
                admitted += moves
            else:
                denials += 1
                denied += moves
        remaining = tuple(
            (period, self.moves_per_period - used)
            for (name, period), used in sorted(self._used.items())
            if name == tenant
        )
        return TenantArbiterLedger(
            name=tenant,
            grants=grants,
            denials=denials,
            moves_admitted=admitted,
            moves_denied=denied,
            moves_per_period=self.moves_per_period,
            budget_remaining=remaining,
        )


class _ArbitratedController:
    """Wrap one tenant's controller so its replans draw from the arbiter."""

    def __init__(self, name: str, inner: OnlineController, arbiter: ReplanArbiter):
        self.name = name
        self.inner = inner
        self.arbiter = arbiter

    @property
    def period(self) -> int:
        return self.inner.period

    def update(self, obs):
        plan = self.inner.update(obs)
        if plan is None:
            return None
        moves = placement_migrations(obs.etg, plan)
        if self.arbiter.admit(self.name, obs.window, self.period, moves):
            return plan
        # The inner controller just accepted a replan (outcome="replan" in
        # its ledger) that the arbiter now denies: record the denial as a
        # structured "deferred" decision — its legacy entry reproduces the
        # historical in-band (window, "deferred:arbiter", moves) 3-tuple.
        last = self.inner.ledger[-1] if self.inner.ledger else None
        self.inner._decide(
            ReplanDecision(
                window=obs.window,
                trigger=last.trigger if last is not None else "arbiter",
                outcome="deferred",
                moves=int(moves),
                candidate_moves=last.candidate_moves if last is not None else (),
            )
        )
        return None


@dataclasses.dataclass(frozen=True)
class MultiTenantRuntimeResult:
    """Per-tenant runtime results plus the cross-tenant summary."""

    names: tuple[str, ...]
    results: tuple[RuntimeResult, ...]
    satisfaction: np.ndarray  # (N,) tail admitted rate / target rate
    arbiter_log: tuple[tuple[str, int, int, bool], ...]
    # Per-tenant arbiter roll-ups (grants, denials, budget remaining per
    # period), aligned with ``names``; empty when run offline.
    arbiter: tuple[TenantArbiterLedger, ...] = ()

    def result_for(self, name: str) -> RuntimeResult:
        return self.results[self.names.index(name)]

    def arbiter_for(self, name: str) -> TenantArbiterLedger:
        return self.arbiter[self.names.index(name)]


class MultiTenantRuntime:
    """Run every tenant's stream on the shared cluster, priced residually.

    Args:
      plan: the fairness allocation (``schedule_tenants`` output).
      tenants: the tenant set the plan was computed for.
      cluster: the shared cluster.
      mtrace: per-tenant traces on one capacity grid
        (``compile_tenant_traces``).
      config: event-loop constants (shared by every tenant's executor).
    """

    def __init__(
        self,
        plan: MultiTenantSchedule,
        tenants: TenantSet,
        cluster: Cluster,
        mtrace: MultiTenantTrace,
        config: RuntimeConfig | None = None,
    ):
        if tuple(t.name for t in tenants) != tuple(a.name for a in plan.allocations):
            raise ValueError("plan allocations must align with the tenant set")
        if mtrace.names != tuple(t.name for t in tenants):
            raise ValueError("mtrace tenants must align with the tenant set")
        self.plan = plan
        self.tenants = tenants
        self.cluster = cluster
        self.mtrace = mtrace
        self.config = config or RuntimeConfig()

    def planned_loads(self) -> np.ndarray:
        """(N, W, m) per-tenant planned machine load per window.

        Linear model at the tenant's allocated rate, demand-capped by its
        offered trace: ``met + min(offered_w, R_alloc) * var``. This is the
        load a co-tenant's executor must assume is spoken for (even-split
        coefficients; realized key skew shifts within a machine's share).
        """
        W = self.mtrace.n_windows
        m = self.cluster.n_machines
        out = np.zeros((len(self.tenants), W, m), dtype=np.float64)
        for i, alloc in enumerate(self.plan.allocations):
            st = ScheduleState.from_etg(alloc.etg, self.cluster)
            eff = np.minimum(self.mtrace.traces[i].rates, alloc.rate)  # (W,)
            out[i] = st.met_load[None, :] + eff[:, None] * st.var_load[None, :]
        return out

    def run(
        self,
        online: bool = True,
        moves_per_period: int = 8,
        controller_kwargs: "dict | None" = None,
        recorder=None,
        device: str | torch.device = "cuda",
    ) -> MultiTenantRuntimeResult:
        """Execute all tenants' windows; returns per-tenant results.

        With ``online=True`` each tenant gets an ``OnlineController`` on
        its residual capacity view, wrapped by one shared ``ReplanArbiter``
        so drift replans cannot starve co-tenants of migration bandwidth.

        ``device`` is where the controllers' replans score their sweeps
        (``"cuda"``, the default, raises without a card; ``"cpu"``).

        A ``repro_torch.obs.TraceRecorder`` passed as ``recorder`` is shared by
        every tenant's executor, controller and the arbiter: each tenant's
        run nests under a ``tenant:<name>`` span, and the per-tenant
        arbiter roll-ups land on the result's ``arbiter`` field either
        way.
        """
        rec = NULL_RECORDER if recorder is None else recorder
        dev = resolve_device(device)
        loads = self.planned_loads()
        total = loads.sum(axis=0)  # (W, m)
        arbiter = ReplanArbiter(moves_per_period, recorder=rec)
        results = []
        sat = np.zeros(len(self.tenants), dtype=np.float64)
        for i, (tenant, alloc) in enumerate(zip(self.tenants, self.plan.allocations)):
            bg = total - loads[i]
            executor = StreamExecutor(
                alloc.etg,
                self.cluster,
                self.mtrace.traces[i],
                config=self.config,
                background_load=bg,
                recorder=rec if rec.enabled else None,
            )
            controller = None
            if online:
                inner = OnlineController(
                    tenant.utg,
                    self.cluster,
                    recorder=rec if rec.enabled else None,
                    device=dev,
                    **(controller_kwargs or {}),
                )
                controller = _ArbitratedController(tenant.name, inner, arbiter)
            with rec.span(f"tenant:{tenant.name}", cat="tenant"):
                res = executor.run(controller=controller)
            results.append(res)
            start = res.n_windows // 2
            sat[i] = float(res.admitted[start:].mean()) / tenant.target_rate
        return MultiTenantRuntimeResult(
            names=self.mtrace.names,
            results=tuple(results),
            satisfaction=sat,
            arbiter_log=tuple(arbiter.log),
            arbiter=tuple(
                arbiter.tenant_summary(name) for name in self.mtrace.names
            ),
        )
