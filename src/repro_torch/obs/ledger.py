"""Structured replan audit ledger.

Every consult of ``OnlineController.update`` that reaches a decision
point produces one :class:`ReplanDecision` carrying the *full* two-sided
guard breakdown — the demand-capped gain, the pause debit, the
move/state cost split, the budget verdict and the candidate move list —
instead of a pre-formatted string.  The legacy ``(window, str)`` log the
tests and benchmarks grew up with is a *derived view*
(:meth:`ReplanDecision.legacy_entry` / :meth:`ReplanLedger.legacy_view`)
so the structured record is the source of truth.

Outcomes:

``no_move``
    Drift fired but ``refine`` returned the incumbent placement (the
    guard never ran; guard fields stay at their defaults).
``budget``
    Transfer cost exceeded ``elastic_budget`` — rejected before the
    benefit comparison.
``skip``
    Guard ran and the demand-capped, pause-debited benefit did not clear
    the transfer cost.
``replan``
    Accepted: the plan is handed to the executor.
``deferred``
    Accepted by the controller but denied by the multi-tenant
    ``ReplanArbiter`` (its per-period move budget was exhausted).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

__all__ = ["ReplanDecision", "ReplanLedger"]

_GUARD_OUTCOMES = frozenset({"budget", "skip", "replan", "deferred"})


def _json_safe(x: float) -> float | str:
    """Floats for JSON: non-finite values become strings ("inf", "nan")."""
    return x if math.isfinite(x) else str(x)


@dataclasses.dataclass(frozen=True)
class ReplanDecision:
    """One controller decision with its full guard breakdown."""

    window: int
    trigger: str                 # drift reason: scale_out/capacity/drain/...
    outcome: str                 # no_move | budget | skip | replan | deferred
    moves: int = 0               # instances that would restart
    state_shipped: float = 0.0   # keyed-state tuples the transfer ships
    gain_rate: float = 0.0       # demand-capped throughput delta (tuples/s)
    benefit: float = 0.0         # gain integrated over horizon − pause_loss
    pause_loss: float = 0.0      # service forgone during migration pauses
    move_cost: float = 0.0       # moves × migration_cost
    state_cost: float = 0.0      # state_shipped × state_cost
    cost: float = 0.0            # move_cost + state_cost
    budget: float = float("inf")  # elastic_budget in force
    demand: float = 0.0          # offered demand cap (tuples/s)
    current_throughput: float = 0.0
    plan_throughput: float = 0.0
    plan_rate: float = 0.0
    horizon_windows: int = 0
    candidate_moves: tuple[str, ...] = ()  # refine's applied move descriptors

    @property
    def accepted(self) -> bool:
        return self.outcome == "replan"

    @property
    def has_guard_breakdown(self) -> bool:
        """True when the two-sided guard actually ran for this decision."""
        return self.outcome in _GUARD_OUTCOMES

    @property
    def message(self) -> str:
        """The legacy log string for this decision (format-compatible)."""
        if self.outcome == "no_move":
            return f"{self.trigger}:no_move"
        if self.outcome == "budget":
            return (
                f"{self.trigger}:budget cost={self.cost:.0f} moves={self.moves} "
                f"state={self.state_shipped:.0f}"
            )
        if self.outcome == "deferred":
            return "deferred:arbiter"
        # skip / replan share the gain-formatted tail.
        return (
            f"{self.trigger}:{self.outcome} gain={self.gain_rate:.2f}/s "
            f"moves={self.moves} state={self.state_shipped:.0f}"
        )

    def legacy_entry(self) -> tuple:
        """The tuple the old ``OnlineController.log`` list carried."""
        if self.outcome == "deferred":
            # The arbiter's historical in-band marker was a 3-tuple.
            return (self.window, "deferred:arbiter", float(self.moves))
        return (self.window, self.message)

    def to_record(self) -> dict[str, Any]:
        """JSON-safe dict for exporters (non-finite floats stringified)."""
        return {
            "window": self.window,
            "trigger": self.trigger,
            "outcome": self.outcome,
            "moves": self.moves,
            "state_shipped": _json_safe(self.state_shipped),
            "gain_rate": _json_safe(self.gain_rate),
            "benefit": _json_safe(self.benefit),
            "pause_loss": _json_safe(self.pause_loss),
            "move_cost": _json_safe(self.move_cost),
            "state_cost": _json_safe(self.state_cost),
            "cost": _json_safe(self.cost),
            "budget": _json_safe(self.budget),
            "demand": _json_safe(self.demand),
            "current_throughput": _json_safe(self.current_throughput),
            "plan_throughput": _json_safe(self.plan_throughput),
            "plan_rate": _json_safe(self.plan_rate),
            "horizon_windows": self.horizon_windows,
            "candidate_moves": list(self.candidate_moves),
        }


class ReplanLedger(list):
    """Ordered list of :class:`ReplanDecision` with derived views."""

    @property
    def accepted(self) -> list[ReplanDecision]:
        return [d for d in self if d.outcome == "replan"]

    @property
    def rejected(self) -> list[ReplanDecision]:
        return [d for d in self if d.outcome != "replan"]

    def legacy_view(self) -> list[tuple]:
        """The old ``OnlineController.log`` contents, tuple for tuple."""
        return [d.legacy_entry() for d in self]

    def to_records(self) -> list[dict[str, Any]]:
        return [d.to_record() for d in self]
