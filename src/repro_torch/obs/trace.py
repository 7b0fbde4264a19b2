"""Dispatch hook of the port's observability layer.

Only the module-global ``_ACTIVE`` slot and the ``record_dispatch`` hook
that ``core.simulator`` calls are ported so far; with no recorder active
(the only state until ``TraceRecorder`` is ported) the hook is a single
global read.
"""

from __future__ import annotations

from typing import Any

__all__ = ["record_dispatch"]

_ACTIVE: Any = None


def record_dispatch(
    requested: str,
    backend: str,
    regime: str,
    elements: int | None,
    n_machines: int | None,
    site: str | None = None,
) -> None:
    """Dispatch-decision hook called by ``resolve_closed_form_device``."""
    rec = _ACTIVE
    if rec is None:
        return
    rec.dispatch(requested, backend, regime, elements, n_machines, site)
