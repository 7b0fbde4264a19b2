"""Schema smoke-check for observability exports.

Usage::

    python -m repro_torch.obs.validate trace.jsonl runtime.trace.json ...

Validates JSONL record streams (``to_jsonl``) and Chrome trace-event
files (``to_chrome_trace``).  Exit status 0 when every file passes, 1 on
the first malformed record, so a schema regression fails the check
instead of producing unloadable traces.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

__all__ = ["validate_file", "validate_jsonl", "validate_chrome", "main"]

_RECORD_TYPES = frozenset({"meta", "span", "event", "dispatch", "decision", "metric"})
_TIMED_TYPES = frozenset({"span", "event", "dispatch", "decision"})
_METRIC_KINDS = frozenset({"counter", "gauge", "histogram"})
_PHASES = frozenset({"X", "i", "I", "M", "B", "E", "C"})


def validate_jsonl(text: str) -> tuple[int, list[str]]:
    """Check a JSONL export; returns (record count, error list)."""
    errors: list[str] = []
    n = 0
    last_ts = 0
    for lineno, line in enumerate(text.splitlines(), start=1):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError as exc:
            errors.append(f"line {lineno}: invalid JSON ({exc})")
            continue
        n += 1
        if not isinstance(rec, dict):
            errors.append(f"line {lineno}: record is not an object")
            continue
        rtype = rec.get("type")
        if rtype not in _RECORD_TYPES:
            errors.append(f"line {lineno}: unknown record type {rtype!r}")
            continue
        if rtype == "meta":
            if not isinstance(rec.get("name"), str):
                errors.append(f"line {lineno}: meta record missing 'name'")
            continue
        if rtype == "metric":
            if not isinstance(rec.get("name"), str):
                errors.append(f"line {lineno}: metric missing 'name'")
            if rec.get("kind") not in _METRIC_KINDS:
                errors.append(f"line {lineno}: metric kind {rec.get('kind')!r} unknown")
            continue
        # span / event / dispatch / decision
        if not isinstance(rec.get("name"), str):
            errors.append(f"line {lineno}: {rtype} missing 'name'")
        if not isinstance(rec.get("cat"), str):
            errors.append(f"line {lineno}: {rtype} missing 'cat'")
        if not isinstance(rec.get("window"), int):
            errors.append(f"line {lineno}: {rtype} missing integer 'window'")
        ts = rec.get("ts")
        if not isinstance(ts, int) or ts <= 0:
            errors.append(f"line {lineno}: {rtype} missing positive integer 'ts'")
        elif ts <= last_ts:
            errors.append(
                f"line {lineno}: virtual clock not monotone (ts={ts} after {last_ts})"
            )
        else:
            last_ts = ts
        if rtype == "span":
            dur = rec.get("dur")
            if not isinstance(dur, int) or dur < 1:
                errors.append(f"line {lineno}: span missing positive integer 'dur'")
    if n == 0:
        errors.append("empty file: no records")
    return n, errors


def validate_chrome(obj: object) -> tuple[int, list[str]]:
    """Check a Chrome trace-event dict; returns (event count, error list)."""
    errors: list[str] = []
    if not isinstance(obj, dict) or not isinstance(obj.get("traceEvents"), list):
        return 0, ["not a trace-event file: missing 'traceEvents' list"]
    events = obj["traceEvents"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        if not isinstance(ev.get("name"), str):
            errors.append(f"{where}: missing 'name'")
        ph = ev.get("ph")
        if ph not in _PHASES:
            errors.append(f"{where}: unknown phase {ph!r}")
            continue
        if not isinstance(ev.get("pid"), int) or not isinstance(ev.get("tid"), int):
            errors.append(f"{where}: missing integer pid/tid")
        if ph == "M":
            continue  # metadata events carry no timestamp
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"{where}: missing non-negative 'ts'")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: complete event missing non-negative 'dur'")
    if not events:
        errors.append("empty trace: no events")
    return len(events), errors


def validate_file(path: "str | Path") -> tuple[int, list[str]]:
    """Validate one export file; format chosen by content sniffing."""
    p = Path(path)
    try:
        text = p.read_text()
    except OSError as exc:
        return 0, [f"cannot read {p}: {exc}"]
    stripped = text.lstrip()
    if stripped.startswith("{") and '"traceEvents"' in stripped[:200]:
        try:
            obj = json.loads(text)
        except ValueError as exc:
            return 0, [f"invalid JSON: {exc}"]
        return validate_chrome(obj)
    return validate_jsonl(text)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m repro_torch.obs.validate <trace.jsonl|trace.json> ...")
        return 2
    status = 0
    for path in argv:
        n, errors = validate_file(path)
        if errors:
            status = 1
            print(f"FAIL {path}: {len(errors)} error(s) in {n} record(s)")
            for err in errors[:20]:
                print(f"  {err}")
            if len(errors) > 20:
                print(f"  ... {len(errors) - 20} more")
        else:
            print(f"OK   {path}: {n} record(s)")
    return status


if __name__ == "__main__":
    raise SystemExit(main())
