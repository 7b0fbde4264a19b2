"""Multi-tenant scheduling on one shared heterogeneous cluster.

N user topologies, each with a contracted target rate and priority, share
the machines. Per-tenant ``ScheduleState``s share one machine-load vector
(exact cross-tenant interference pricing via the linear load model), a
water-filling loop allocates weighted max-min fair rates, and candidate
sweeps of *different* tenants batch into single closed-form kernel calls
(tenants become rows). See ``docs/architecture.md`` (multi-tenant
section) for the derivation and guarantees.

The same names as ``repro.multitenant``. Host bookkeeping (tenant sets,
shared loads, water filling) is NumPy, as in the reference; every batched
sweep — ``TenantBatchScorer``, the warm starts' and escapes' ``refine``,
the runtime's replans — takes ``device=`` and defaults to ``"cuda"``.
"""

from repro_torch.multitenant.batch import TenantBatchScorer
from repro_torch.multitenant.fairness import (
    MultiTenantSchedule,
    TenantAllocation,
    fair_shares,
    fair_slice_floors,
    schedule_tenants,
)
from repro_torch.multitenant.runtime import (
    MultiTenantRuntime,
    MultiTenantRuntimeResult,
    MultiTenantTrace,
    ReplanArbiter,
    compile_tenant_traces,
)
from repro_torch.multitenant.state import MultiTenantState
from repro_torch.multitenant.tenants import Tenant, TenantSet

__all__ = [
    "Tenant",
    "TenantSet",
    "MultiTenantState",
    "TenantBatchScorer",
    "TenantAllocation",
    "MultiTenantSchedule",
    "fair_shares",
    "fair_slice_floors",
    "schedule_tenants",
    "MultiTenantTrace",
    "compile_tenant_traces",
    "ReplanArbiter",
    "MultiTenantRuntime",
    "MultiTenantRuntimeResult",
]
