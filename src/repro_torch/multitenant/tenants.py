"""Tenant descriptors for multi-tenant scheduling.

A *tenant* is one user topology submitted to the shared heterogeneous
cluster together with its service contract: a target input rate (the
tuple/s the tenant paid for) and a priority weight. All tenants share the
cluster's profile table — a tenant's ``component_types`` index into the
profile the cluster was built with, exactly as in the single-tenant path.

``TenantSet`` is the canonical container: it enforces unique tenant names
and defines the *canonical order* (sorted by name) that every allocation
loop processes tenants in, which is what makes the fairness allocation
invariant under permutations of the input list (tested in
``tests/test_torch_multitenant.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

from repro_torch.core import cost_model
from repro_torch.core.graph import UserGraph

__all__ = ["Tenant", "TenantSet"]


@dataclasses.dataclass(frozen=True)
class Tenant:
    """One user topology plus its service contract.

    Attributes:
      name: unique tenant identifier (canonical ordering key).
      utg: the tenant's user topology graph.
      target_rate: contracted topology input rate R_target (tuples/s), > 0.
        Fairness is expressed on the satisfaction ratio ``R / R_target``.
      priority: weight applied to the satisfaction ratio; a priority-2
        tenant reaches the same fairness level at half the satisfaction
        of a priority-1 tenant (weighted max-min, Ghaderi et al.).
      skew: optional per-instance key-share model for keyed groupings
        (``cost_model.SkewModel``); must be built on ``utg``.
    """

    name: str
    utg: UserGraph
    target_rate: float
    priority: float = 1.0
    skew: "cost_model.SkewModel | None" = None

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if not self.target_rate > 0.0:
            raise ValueError(f"target_rate must be > 0, got {self.target_rate}")
        if not self.priority > 0.0:
            raise ValueError(f"priority must be > 0, got {self.priority}")
        if self.skew is not None and self.skew.utg is not self.utg:
            raise ValueError(f"tenant {self.name!r}: skew model built for a different topology")

    @property
    def level_scale(self) -> float:
        """Denominator mapping a rate to its fairness level:
        ``level = R / (target_rate * priority)``."""
        return self.target_rate * self.priority


class TenantSet:
    """Validated, order-preserving collection of tenants.

    Keeps the tenants in submission order (results are reported in that
    order) while exposing ``canonical_order`` — indices sorted by tenant
    name — which the water-filling loop uses for every tie-break so the
    allocation does not depend on submission order.
    """

    __slots__ = ("tenants",)

    def __init__(self, tenants: Sequence[Tenant]):
        tenants = tuple(tenants)
        if not tenants:
            raise ValueError("TenantSet needs at least one tenant")
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"duplicate tenant names: {dupes}")
        self.tenants = tenants

    def __len__(self) -> int:
        return len(self.tenants)

    def __iter__(self) -> Iterator[Tenant]:
        return iter(self.tenants)

    def __getitem__(self, i: int) -> Tenant:
        return self.tenants[i]

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(t.name for t in self.tenants)

    def canonical_order(self) -> list[int]:
        """Indices into the submission order, sorted by tenant name."""
        return sorted(range(len(self.tenants)), key=lambda i: self.tenants[i].name)

    def index_of(self, name: str) -> int:
        for i, t in enumerate(self.tenants):
            if t.name == name:
                return i
        raise KeyError(name)
