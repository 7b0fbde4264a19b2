"""Deterministic observability of the port: tracing, metrics, audit ledger,
exporters.

The layer answers "why did the runtime do that?" without perturbing what
it observes:

* ``trace``   — ``TraceRecorder``: nestable spans + point events on a
                virtual clock (window index + integer tick); wall-clock
                opt-in and strippable; ``NullRecorder`` zero-overhead
                default; process-wide activation feeds the closed-form
                dispatch hook (device resolutions);
* ``metrics`` — counter / gauge / histogram registry (per-component
                throughput, guard evals, arbiter grants/denials, queue
                high-water marks);
* ``ledger``  — ``ReplanDecision``: every controller verdict with the
                full two-sided guard breakdown; the legacy string log is
                a derived view;
* ``export``  — JSONL + Chrome trace-event (Perfetto) + text summary;
* ``validate``— ``python -m repro_torch.obs.validate`` schema check.

The same names as ``repro.obs``; exports of one deterministic run equal the
reference's once the values that name a backend or a device are mapped.
"""

from repro_torch.obs.export import summary, to_chrome_trace, to_jsonl
from repro_torch.obs.ledger import ReplanDecision, ReplanLedger
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import (
    NULL_RECORDER,
    DispatchDecision,
    NullRecorder,
    TraceRecorder,
    active_recorder,
    record_dispatch,
)

__all__ = [
    "TraceRecorder",
    "NullRecorder",
    "NULL_RECORDER",
    "DispatchDecision",
    "active_recorder",
    "record_dispatch",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "ReplanDecision",
    "ReplanLedger",
    "to_jsonl",
    "to_chrome_trace",
    "summary",
]
