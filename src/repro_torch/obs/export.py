"""Exporters: JSONL, Chrome trace-event JSON (Perfetto), text summary.

All exporters serialize with ``sort_keys=True`` and compact separators,
so a deterministic recorder produces *byte-identical* output across
reruns once wall-clock fields are stripped (``strip_wall=True``) or the
recorder ran with ``wall_clock=False``.
"""

from __future__ import annotations

import json
from collections import Counter as _TallyCounter
from pathlib import Path
from typing import Any

from repro_torch.obs.trace import NullRecorder, TraceRecorder

__all__ = ["to_jsonl", "to_chrome_trace", "summary"]

_WALL_KEYS = ("wall_s", "wall_dur_s")


def _coerce(obj: Any) -> Any:
    """json.dumps fallback for numpy scalars / arrays that leaked into args."""
    if hasattr(obj, "item"):
        return obj.item()
    if hasattr(obj, "tolist"):
        return obj.tolist()
    return str(obj)


def _dumps(obj: Any) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"), default=_coerce)


def to_jsonl(
    recorder: "TraceRecorder | NullRecorder",
    path: "str | Path | None" = None,
    strip_wall: bool = False,
) -> str:
    """Serialize a recorder to JSONL: meta header, records, metric snapshot.

    One JSON object per line.  ``strip_wall=True`` drops the opt-in
    ``wall_s`` / ``wall_dur_s`` fields so recorder-on reruns compare
    byte-for-byte.
    """
    lines = [
        _dumps(
            {
                "type": "meta",
                "name": recorder.name,
                "wall_clock": bool(recorder.wall_clock) and not strip_wall,
                "records": len(recorder.records),
            }
        )
    ]
    for rec in recorder.records:
        if strip_wall and any(k in rec for k in _WALL_KEYS):
            rec = {k: v for k, v in rec.items() if k not in _WALL_KEYS}
        lines.append(_dumps(rec))
    for m in recorder.metrics.snapshot():
        lines.append(_dumps({"type": "metric", **m}))
    text = "\n".join(lines) + "\n"
    if path is not None:
        Path(path).write_text(text)
    return text


def to_chrome_trace(
    recorder: "TraceRecorder | NullRecorder",
    path: "str | Path | None" = None,
) -> dict[str, Any]:
    """Serialize to the Chrome trace-event format (Perfetto-loadable).

    Virtual-clock ticks map to the format's microsecond ``ts`` axis, one
    thread per record category.  Spans become complete ("X") events,
    point events / dispatch decisions / replan decisions become instants
    ("i"); the metric snapshot lands as instants on a trailing
    ``metrics`` thread.
    """
    events: list[dict[str, Any]] = []
    tids: dict[str, int] = {}

    def tid_for(cat: str) -> int:
        tid = tids.get(cat)
        if tid is None:
            tid = tids[cat] = len(tids)
        return tid

    events.append(
        {"name": "process_name", "ph": "M", "pid": 0, "tid": 0, "args": {"name": recorder.name}}
    )
    body: list[dict[str, Any]] = []
    for rec in recorder.records:
        cat = rec["cat"]
        args = dict(rec.get("args") or {})
        args["window"] = rec["window"]
        if "wall_dur_s" in rec:
            args["wall_dur_s"] = rec["wall_dur_s"]
        ev: dict[str, Any] = {
            "name": rec["name"],
            "cat": cat,
            "ts": rec["ts"],
            "pid": 0,
            "tid": tid_for(cat),
            "args": args,
        }
        if rec["type"] == "span":
            ev["ph"] = "X"
            ev["dur"] = max(int(rec.get("dur", 1)), 1)
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
        body.append(ev)
    last_ts = recorder.records[-1]["ts"] if recorder.records else 0
    for i, m in enumerate(recorder.metrics.snapshot()):
        body.append(
            {
                "name": m["name"],
                "cat": "metrics",
                "ph": "i",
                "s": "t",
                "ts": last_ts + 1 + i,
                "pid": 0,
                "tid": tid_for("metrics"),
                "args": m,
            }
        )
    for cat, tid in tids.items():
        events.append(
            {"name": "thread_name", "ph": "M", "pid": 0, "tid": tid, "args": {"name": cat}}
        )
    events.extend(body)
    trace = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path is not None:
        Path(path).write_text(_dumps(trace) + "\n")
    return trace


def summary(recorder: "TraceRecorder | NullRecorder") -> str:
    """Plain-text roll-up: spans, events, dispatch routing, metrics."""
    lines = [f"trace '{recorder.name}': {len(recorder.records)} records, tick={recorder.tick}"]

    span_count: _TallyCounter = _TallyCounter()
    span_ticks: _TallyCounter = _TallyCounter()
    span_wall: dict[str, float] = {}
    event_count: _TallyCounter = _TallyCounter()
    decision_count: _TallyCounter = _TallyCounter()
    for rec in recorder.records:
        if rec["type"] == "span":
            span_count[rec["name"]] += 1
            span_ticks[rec["name"]] += rec.get("dur", 0)
            if "wall_dur_s" in rec:
                span_wall[rec["name"]] = span_wall.get(rec["name"], 0.0) + rec["wall_dur_s"]
        elif rec["type"] == "event":
            event_count[rec["name"]] += 1
        elif rec["type"] == "decision":
            decision_count[rec["name"]] += 1
    if span_count:
        lines.append("spans:")
        for name, n in span_count.most_common():
            wall = f"  wall={span_wall[name]:.4f}s" if name in span_wall else ""
            lines.append(f"  {name:<28} n={n:<5} ticks={span_ticks[name]}{wall}")
    if event_count:
        lines.append("events:")
        for name, n in event_count.most_common():
            lines.append(f"  {name:<28} n={n}")
    if decision_count:
        lines.append("replan decisions:")
        for name, n in sorted(decision_count.items()):
            lines.append(f"  {name:<28} n={n}")
    if recorder.dispatch_log:
        routes: _TallyCounter = _TallyCounter()
        for d in recorder.dispatch_log:
            routes[(d.site or "?", d.regime, d.backend)] += 1
        lines.append("closed-form dispatch:")
        for (site, regime, backend), n in sorted(routes.items()):
            lines.append(f"  {site:<24} {regime:<8} -> {backend:<6} n={n}")
    metrics = recorder.metrics.snapshot()
    if metrics:
        lines.append("metrics:")
        for m in metrics:
            if m["kind"] == "gauge":
                lines.append(f"  {m['name']:<36} gauge last={m['value']:.4g} hwm={m['hwm']:.4g}")
            elif m["kind"] == "histogram":
                lines.append(f"  {m['name']:<36} hist  n={m['count']} total={m['total']:.4g}")
            else:
                lines.append(f"  {m['name']:<36} count value={m['value']:.6g}")
    return "\n".join(lines)
