"""Counter / gauge / histogram registry for new observability series.

The executor's paper-facing metric arrays (throughput, queue, drops —
everything hashed by ``RuntimeResult.fingerprint``) stay exactly where
they are; this registry exists for *additional* series introduced by the
observability layer: per-component throughput totals, guard-evaluation
counts, arbiter grants/denials, queue high-water marks.  All state is
plain Python numbers updated in deterministic program order, so
``snapshot()`` output is reproducible across reruns.
"""

from __future__ import annotations

import bisect
from typing import Any

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_METRICS",
]


class Counter:
    """Monotonically increasing sum."""

    kind = "counter"

    def __init__(self, name: str) -> None:
        self.name = name
        self.value: float = 0.0
        self.count: int = 0

    def add(self, amount: float = 1.0) -> None:
        self.value += amount
        self.count += 1

    def to_record(self) -> dict[str, Any]:
        return {"name": self.name, "kind": self.kind, "value": self.value, "count": self.count}


class Gauge:
    """Last-set value with a high-water mark."""

    kind = "gauge"

    def __init__(self, name: str) -> None:
        self.name = name
        self.value: float = 0.0
        self.hwm: float = float("-inf")
        self.count: int = 0

    def set(self, value: float) -> None:
        self.value = value
        if value > self.hwm:
            self.hwm = value
        self.count += 1

    def to_record(self) -> dict[str, Any]:
        hwm = self.hwm if self.count else 0.0
        return {"name": self.name, "kind": self.kind, "value": self.value, "hwm": hwm, "count": self.count}


class Histogram:
    """Fixed-bucket histogram with overflow bucket and running sum."""

    kind = "histogram"

    def __init__(self, name: str, edges: tuple[float, ...]) -> None:
        self.name = name
        self.edges = tuple(float(e) for e in edges)
        self.counts = [0] * (len(self.edges) + 1)
        self.total: float = 0.0
        self.count: int = 0

    def record(self, value: float) -> None:
        self.counts[bisect.bisect_right(self.edges, value)] += 1
        self.total += value
        self.count += 1

    def to_record(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "kind": self.kind,
            "edges": list(self.edges),
            "counts": list(self.counts),
            "total": self.total,
            "count": self.count,
        }


_DEFAULT_EDGES = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0, 1000.0)


class MetricsRegistry:
    """Insertion-ordered registry; get-or-create accessors per kind."""

    enabled = True

    def __init__(self) -> None:
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def counter(self, name: str) -> Counter:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Counter(name)
        elif not isinstance(m, Counter):
            raise TypeError(f"metric {name!r} already registered as {m.kind}")
        return m

    def gauge(self, name: str) -> Gauge:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Gauge(name)
        elif not isinstance(m, Gauge):
            raise TypeError(f"metric {name!r} already registered as {m.kind}")
        return m

    def histogram(self, name: str, edges: tuple[float, ...] = _DEFAULT_EDGES) -> Histogram:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Histogram(name, edges)
        elif not isinstance(m, Histogram):
            raise TypeError(f"metric {name!r} already registered as {m.kind}")
        return m

    def __len__(self) -> int:
        return len(self._metrics)

    def __iter__(self):
        return iter(self._metrics.values())

    def snapshot(self) -> list[dict[str, Any]]:
        """All metrics as json-safe records, in registration order."""
        return [m.to_record() for m in self._metrics.values()]


class _NullMetric:
    def add(self, amount: float = 1.0) -> None:
        return None

    def set(self, value: float) -> None:
        return None

    def record(self, value: float) -> None:
        return None


_NULL_METRIC = _NullMetric()


class _NullMetricsRegistry:
    """No-op registry used by ``NullRecorder``."""

    enabled = False

    def counter(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def gauge(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def histogram(self, name: str, edges: tuple[float, ...] = _DEFAULT_EDGES) -> _NullMetric:
        return _NULL_METRIC

    def __len__(self) -> int:
        return 0

    def __iter__(self):
        return iter(())

    def snapshot(self) -> list[dict[str, Any]]:
        return []


NULL_METRICS = _NullMetricsRegistry()
