"""Deterministic trace recording on a virtual clock.

The recorder is the backbone of the observability layer: every span,
point event, dispatch decision and replan decision is appended to a
single ordered record list. Ordering is given by a *virtual clock* — a
monotonically increasing integer tick bumped once per record plus the
current window index — so two runs of the same deterministic program
produce byte-identical exports. Wall-clock timings are opt-in
(``wall_clock=True``) and are carried in dedicated ``wall_*`` fields so
exporters can strip them for reproducibility checks.

Design constraints:

* recording must never perturb the computation it observes — the
  recorder only appends to Python lists and bumps counters, and the
  ``NullRecorder`` default makes every hook a no-op attribute access;
* the closed-form dispatch hook (:func:`record_dispatch`) is called from
  ``repro_torch.core.simulator.resolve_closed_form_device`` on *every*
  sweep's device resolution, so the inactive path is a single
  module-global ``None`` check;
* this module imports only the standard library (and sibling
  ``repro_torch.obs`` modules), so it can be imported from anywhere in
  the package without cycles.

A dispatch record keeps the reference's keys (``requested``, ``backend``,
``regime``, ``elements``, ``n_machines``, ``site``); its ``requested`` and
``backend`` values name devices (``"cuda"``, ``"cpu"``) where the
reference's name backends.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Any, Iterator

from repro_torch.obs.metrics import MetricsRegistry, NULL_METRICS

__all__ = [
    "DispatchDecision",
    "NullRecorder",
    "NULL_RECORDER",
    "TraceRecorder",
    "active_recorder",
    "record_dispatch",
]


@dataclass(frozen=True)
class DispatchDecision:
    """One closed-form device resolution (``resolve_closed_form_device``)."""

    requested: str
    backend: str
    regime: str
    elements: int | None
    n_machines: int | None
    site: str | None
    window: int

    def to_record(self) -> dict[str, Any]:
        return {
            "requested": self.requested,
            "backend": self.backend,
            "regime": self.regime,
            "elements": self.elements,
            "n_machines": self.n_machines,
            "site": self.site,
        }


class _Span:
    """Lightweight span context manager (cheaper than a generator CM).

    The record is emitted at ``__enter__`` (so record order equals
    program order even for nested spans) and its ``dur`` — in virtual
    ticks — is filled in at ``__exit__``.  The object returned by
    ``__enter__`` is the record dict, which the caller may mutate to
    attach result arguments discovered during the span.
    """

    __slots__ = ("_recorder", "_name", "_cat", "_args", "_rec", "_w0")

    def __init__(self, recorder: "TraceRecorder", name: str, cat: str,
                 args: dict[str, Any]) -> None:
        self._recorder = recorder
        self._name = name
        self._cat = cat
        self._args = args
        self._rec: dict[str, Any] | None = None
        self._w0 = 0.0

    def __enter__(self) -> dict[str, Any]:
        rec = self._recorder._record("span", self._name, self._cat, self._args)
        self._rec = rec
        if self._recorder.wall_clock:
            self._w0 = time.perf_counter()
        return rec

    def __exit__(self, *exc: Any) -> None:
        recorder = self._recorder
        rec = self._rec
        recorder._tick += 1
        rec["dur"] = recorder._tick - rec["ts"]
        if recorder.wall_clock:
            rec["wall_dur_s"] = time.perf_counter() - self._w0
        return None


class TraceRecorder:
    """Collects spans, events and decisions on a deterministic virtual clock.

    Parameters
    ----------
    name:
        Label for the run; becomes the process name in Chrome traces and
        the ``meta`` header of JSONL exports.
    wall_clock:
        When ``True``, spans and events additionally carry
        ``wall_s`` / ``wall_dur_s`` fields from ``time.perf_counter``.
        These fields are *never* part of the virtual clock and exporters
        can strip them (``strip_wall=True``) for byte-identical reruns.
    """

    enabled = True

    def __init__(self, name: str = "run", wall_clock: bool = False) -> None:
        self.name = name
        self.wall_clock = wall_clock
        self.records: list[dict[str, Any]] = []
        self.metrics = MetricsRegistry()
        self._tick = 0
        self._window = -1
        self._wall0 = time.perf_counter()
        self._dispatch_counters: dict[tuple[str, str], Any] = {}
        self._dispatch_rows: list[tuple] = []
        self._dispatch_cache: list[DispatchDecision] = []

    # ---------------------------------------------------------------- clock

    @property
    def tick(self) -> int:
        return self._tick

    @property
    def window(self) -> int:
        return self._window

    def set_window(self, window: int) -> None:
        """Advance the virtual clock to a new window index."""
        self._window = int(window)

    # -------------------------------------------------------------- records

    def _record(
        self,
        rtype: str,
        name: str,
        cat: str,
        args: dict[str, Any] | None,
    ) -> dict[str, Any]:
        self._tick += 1
        rec: dict[str, Any] = {
            "type": rtype,
            "name": name,
            "cat": cat,
            "window": self._window,
            "ts": self._tick,
        }
        if args:
            rec["args"] = args
        if self.wall_clock:
            rec["wall_s"] = time.perf_counter() - self._wall0
        self.records.append(rec)
        return rec

    def event(self, name: str, cat: str = "event", **args: Any) -> dict[str, Any]:
        """Record an instantaneous point event."""
        return self._record("event", name, cat, args or None)

    def span(self, name: str, cat: str = "span", **args: Any) -> _Span:
        """Record a nestable span (see :class:`_Span` for semantics)."""
        return _Span(self, name, cat, args)

    def dispatch(
        self,
        requested: str,
        backend: str,
        regime: str,
        elements: int | None,
        n_machines: int | None,
        site: str | None,
    ) -> None:
        """Record one closed-form device resolution.

        Hot path — called once per scoring sweep during refine.  The
        trace record is a direct dict literal, the per-route counter is
        cached by ``(regime, backend)``, and the :class:`DispatchDecision`
        objects are materialized lazily by the :attr:`dispatch_log`
        property, so the per-call cost is two appends and a counter bump.
        """
        tick = self._tick + 1
        self._tick = tick
        window = self._window
        self._dispatch_rows.append(
            (requested, backend, regime, elements, n_machines, site, window)
        )
        rec: dict[str, Any] = {
            "type": "dispatch",
            "name": "closed_form_dispatch",
            "cat": "dispatch",
            "window": window,
            "ts": tick,
            "args": {
                "requested": requested,
                "backend": backend,
                "regime": regime,
                "elements": None if elements is None else int(elements),
                "n_machines": None if n_machines is None else int(n_machines),
                "site": site,
            },
        }
        if self.wall_clock:
            rec["wall_s"] = time.perf_counter() - self._wall0
        self.records.append(rec)
        ctr = self._dispatch_counters.get((regime, backend))
        if ctr is None:
            ctr = self.metrics.counter(f"dispatch.{regime}.{backend}")
            self._dispatch_counters[(regime, backend)] = ctr
        ctr.add(1)

    @property
    def dispatch_log(self) -> list[DispatchDecision]:
        """All device resolutions seen so far, as :class:`DispatchDecision`.

        Materialized lazily from the compact rows the hot path appends;
        repeated access only converts rows added since the last call.
        """
        rows = self._dispatch_rows
        cache = self._dispatch_cache
        if len(cache) != len(rows):
            for req, backend, regime, elements, n_machines, site, window in rows[
                len(cache):
            ]:
                cache.append(
                    DispatchDecision(
                        requested=str(req),
                        backend=str(backend),
                        regime=str(regime),
                        elements=None if elements is None else int(elements),
                        n_machines=None if n_machines is None else int(n_machines),
                        site=site,
                        window=window,
                    )
                )
        return cache

    def decision(self, dec: Any) -> None:
        """Record a structured replan decision (``obs.ledger.ReplanDecision``)."""
        self._record("decision", f"replan:{dec.outcome}", "decision", dec.to_record())

    # ------------------------------------------------------------ activation

    def activate(self) -> contextlib.AbstractContextManager["TraceRecorder"]:
        """Install this recorder as the process-wide active recorder.

        The active recorder is the target of :func:`record_dispatch`,
        which instruments code (the closed-form device resolver) too far
        from the call site to thread a recorder argument through.
        Activation nests: the previous active recorder is restored on
        exit.
        """
        return _activate(self)


@contextlib.contextmanager
def _activate(rec: TraceRecorder) -> Iterator[TraceRecorder]:
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = rec
    try:
        yield rec
    finally:
        _ACTIVE = prev


_ACTIVE: TraceRecorder | None = None


def active_recorder() -> TraceRecorder | None:
    """The currently activated :class:`TraceRecorder`, or ``None``."""
    return _ACTIVE


def record_dispatch(
    requested: str,
    backend: str,
    regime: str,
    elements: int | None,
    n_machines: int | None,
    site: str | None = None,
) -> None:
    """Dispatch-decision hook called by ``resolve_closed_form_device``.

    A single global read when no recorder is active, so the instrumented
    resolver costs nothing in normal operation.
    """
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
    """Zero-overhead recorder: every hook is a no-op.

    Shared singleton :data:`NULL_RECORDER` is the default everywhere a
    recorder is accepted, so un-instrumented runs pay only ``enabled``
    attribute checks.
    """

    enabled = False
    wall_clock = False
    name = "null"
    records: list[dict[str, Any]] = []
    dispatch_log: list[DispatchDecision] = []
    metrics = NULL_METRICS
    tick = 0
    window = -1

    def set_window(self, window: int) -> None:
        return None

    def event(self, name: str, cat: str = "event", **args: Any) -> None:
        return None

    def span(self, name: str, cat: str = "span", **args: Any) -> _NullContext:
        return _NULL_CTX

    def dispatch(self, *args: Any, **kwargs: Any) -> None:
        return None

    def decision(self, dec: Any) -> None:
        return None

    def activate(self) -> _NullContext:
        return _NULL_CTX


NULL_RECORDER = NullRecorder()
