"""Dispatch hook and null recorder of the port's observability layer.

Ported so far: the module-global ``_ACTIVE`` slot, the ``record_dispatch``
hook that ``core.simulator`` calls, and ``NullRecorder`` — the no-op
recorder the streaming runtime's executor and controller hold by default,
so their ``with self.recorder.activate()`` / ``rec.enabled`` structure
stands as in the reference. The real ``TraceRecorder`` is ROADMAP A11;
until then no recorder is ever active and the hook is a single global read.
"""

from __future__ import annotations

from typing import Any

__all__ = ["NULL_RECORDER", "NullRecorder", "record_dispatch", "require_null_recorder"]

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


class _NullContext:
    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: Any) -> None:
        return None


_NULL_CTX = _NullContext()


class NullRecorder:
    """Zero-overhead recorder: every hook is a no-op and ``enabled`` is
    False, so instrumented code pays only attribute checks."""

    enabled = False

    def set_window(self, window: int) -> None:
        return None

    def event(self, name: str, cat: str = "event", **args: Any) -> None:
        return None

    def span(self, name: str, cat: str = "span", **args: Any) -> _NullContext:
        return _NULL_CTX

    def decision(self, dec: Any) -> None:
        return None

    def activate(self) -> _NullContext:
        return _NULL_CTX


NULL_RECORDER = NullRecorder()


def require_null_recorder(recorder: Any) -> NullRecorder:
    """``NULL_RECORDER`` for ``recorder=None``; anything else raises until
    the port has a real recorder (ROADMAP A11)."""
    if recorder is not None:
        raise NotImplementedError(
            "the port has no TraceRecorder yet (ROADMAP A11): pass recorder=None"
        )
    return NULL_RECORDER
