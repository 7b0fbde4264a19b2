"""Shared-load view over per-tenant schedule states.

Every tenant keeps its own ``ScheduleState`` (built on the *full* shared
cluster, so profile slices and machine indices are cluster-global), and the
multi-tenant state owns one rate vector. Because eq. 5/6 are linear in the
topology input rate, tenant t's exact machine load is

    load_t(w) = met_load_t(w) + R_t * var_load_t(w)

with the same cached coefficients the single-tenant closed form uses
(skew-aware when the tenant has a key-share model). Cross-tenant
interference is therefore priced exactly: the capacity left for tenant t is
``cap - sum_{s != t} load_s``, and t's residual maximum stable rate is the
usual closed form against that residual head room.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.first_assignment import first_assignment
from repro_torch.core.schedule_state import ScheduleState
from repro_torch.core.profiles import Cluster

from repro_torch.multitenant.tenants import Tenant, TenantSet

__all__ = ["MultiTenantState"]


class MultiTenantState:
    """N per-tenant ``ScheduleState``s sharing one machine-load vector."""

    __slots__ = ("tenant_set", "cluster", "states", "rates")

    def __init__(
        self,
        tenant_set: TenantSet,
        cluster: Cluster,
        states: list[ScheduleState],
        rates: np.ndarray | None = None,
    ):
        if len(states) != len(tenant_set):
            raise ValueError("one ScheduleState per tenant required")
        for st in states:
            if st.cluster.n_machines != cluster.n_machines:
                raise ValueError("tenant state built for a different cluster width")
        self.tenant_set = tenant_set
        self.cluster = cluster
        self.states = states
        self.rates = (
            np.zeros(len(states), dtype=np.float64)
            if rates is None
            else np.asarray(rates, dtype=np.float64).copy()
        )

    @classmethod
    def first_assignment(
        cls, tenant_set: TenantSet, cluster: Cluster, r0: float = 1.0
    ) -> "MultiTenantState":
        """Minimal one-instance-per-component placement for every tenant.

        Tenants are placed in canonical (name) order; each placement sees
        the residual capacity left by the fixed (MET) load of the tenants
        placed before it, so early placements steer later ones away from
        machines that are already claimed — the multi-tenant analogue of
        Algorithm 1's load accounting.
        """
        states: list[ScheduleState | None] = [None] * len(tenant_set)
        residual = cluster.capacity.astype(np.float64).copy()
        mem_resid = (
            cluster.mem_capacity.astype(np.float64).copy()
            if cluster.has_memory
            else None
        )
        for i in cls._canonical(tenant_set):
            tenant = tenant_set[i]
            view = cluster.with_capacity(residual, mem_capacity=mem_resid)
            etg = first_assignment(tenant.utg, view, r0)
            st = ScheduleState.from_etg(etg, cluster, skew=tenant.skew)
            states[i] = st
            residual = residual - st.met_load
            if mem_resid is not None:
                mem_resid = mem_resid - st.mem_load
        return cls(tenant_set, cluster, [st for st in states if st is not None])

    @staticmethod
    def _canonical(tenant_set: TenantSet) -> list[int]:
        return tenant_set.canonical_order()

    # ------------------------------------------------------- load algebra

    def load_of(self, t: int) -> np.ndarray:
        """(m,) exact machine load of tenant ``t`` at its current rate.

        On network-modelled clusters the tenant's cut-traffic load (also
        linear in its rate) is part of the variable coefficient, so
        cross-tenant interference prices network CPU exactly too.
        """
        st = self.states[t]
        var = st.var_load
        if self.cluster.has_network:
            var = var + st.net_load
        return st.met_load + float(self.rates[t]) * var

    def total_load(self) -> np.ndarray:
        """(m,) summed machine load of all tenants.

        Accumulated in canonical (name) order, not submission order —
        float addition is not associative, and every permutation-invariance
        guarantee downstream rests on cross-tenant reductions summing in
        one canonical sequence.
        """
        total = np.zeros(self.cluster.n_machines, dtype=np.float64)
        for t in self._canonical(self.tenant_set):
            total += self.load_of(t)
        return total

    def residual_capacity(self, t: int) -> np.ndarray:
        """(m,) capacity left for tenant ``t`` by everyone else's load."""
        return self.cluster.capacity - (self.total_load() - self.load_of(t))

    def total_mem_load(self) -> np.ndarray:
        """(m,) summed memory load of all tenants (canonical order; memory
        demands are rate-independent, so no rate fold is needed)."""
        total = np.zeros(self.cluster.n_machines, dtype=np.float64)
        for t in self._canonical(self.tenant_set):
            total += self.states[t].mem_load
        return total

    def residual_mem_capacity(self, t: int) -> np.ndarray:
        """(m,) memory capacity left for tenant ``t`` by everyone else."""
        return self.cluster.mem_capacity - (
            self.total_mem_load() - self.states[t].mem_load
        )

    def residual_cluster(self, t: int) -> Cluster:
        """Cluster view whose capacity is tenant ``t``'s residual head room.

        Feeding this to single-tenant ``refine``/``schedule`` makes their
        moves respect every other tenant's committed allocation by
        construction — a candidate that would evict a neighbour below its
        share simply scores as infeasible. On memory-modelled clusters the
        residual memory capacity is carried the same way (neighbours'
        rate-independent working sets are subtracted); the distance matrix
        and penalty pass through unchanged.
        """
        mem = self.residual_mem_capacity(t) if self.cluster.has_memory else None
        return self.cluster.with_capacity(
            self.residual_capacity(t), mem_capacity=mem
        )

    def residual_rstar(self, t: int) -> float:
        """Closed-form max stable rate of tenant ``t`` on its residual.

        Only machines where the tenant actually has load constrain it: a
        machine the tenant doesn't touch whose residual dips a few ulps
        below zero (co-tenants summing to exactly capacity) must not
        collapse the rate to 0.
        """
        st = self.states[t]
        if self.cluster.has_memory and np.any(
            st.mem_load > self.residual_mem_capacity(t)
        ):
            return 0.0
        head = self.residual_capacity(t) - st.met_load
        var = st.var_load
        if self.cluster.has_network:
            var = var + st.net_load
        if np.any((head < 0.0) & ((st.met_load > 0.0) | (var > 0.0))):
            return 0.0
        with np.errstate(divide="ignore"):
            limits = np.where(var > 0.0, head / np.maximum(var, 1e-300), np.inf)
        return float(max(np.min(limits), 0.0))

    def feasible(self, slack: float = 1e-9) -> bool:
        """Shared-load invariant: total load within capacity (+``slack``).

        On memory-modelled clusters the fleet's summed working sets must
        also fit each machine's memory (same relative slack — this is an
        invariant check over float sums, not an admission rule).
        """
        cap = self.cluster.capacity
        if not np.all(self.total_load() <= cap + slack * np.maximum(cap, 1.0)):
            return False
        if self.cluster.has_memory:
            mcap = self.cluster.mem_capacity
            if not np.all(
                self.total_mem_load() <= mcap + slack * np.maximum(mcap, 1.0)
            ):
                return False
        return True

    def replace_state(self, t: int, state: ScheduleState) -> None:
        """Swap tenant ``t``'s placement (e.g. after a refine round)."""
        if state.cluster.n_machines != self.cluster.n_machines:
            raise ValueError("replacement state built for a different cluster width")
        self.states[t] = state

    def levels(self) -> np.ndarray:
        """(N,) fairness level of each tenant: ``R_t / (target_t * prio_t)``."""
        scales = np.array([t.level_scale for t in self.tenant_set], dtype=np.float64)
        return self.rates / scales
