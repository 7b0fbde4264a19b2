"""Declarative workload traces for the streaming runtime.

A ``TraceSpec`` describes a time-varying workload as a base offered rate
plus a tuple of composable *events* — rate ramps, bursts, sinusoidal
drift, multiplicative noise, machine slowdown/removal — applied in order.
``TraceSpec.compile(cluster, seed)`` lowers the spec to a ``CompiledTrace``:
two dense arrays, the per-window offered spout rate ``rates`` (W,) and the
per-window machine capacity grid ``capacity`` (W, m). Everything stochastic
(burst jitter, rate noise) is drawn from ``np.random.default_rng(seed)``
during compilation, so a compiled trace is a pure value: the executor and
the batch evaluator (``eval_torch``) consume the same arrays, and
repeated runs are bit-identical by construction.

This mirrors the paper's §6.3 measurement protocol — "gradually increase
the input rate until the cluster saturates" — as the ``rate_ramp`` event,
and extends it with the drift/failure scenarios evaluated by the online
controller (see docs/paper_map.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import UserGraph
from repro_torch.core.profiles import Cluster

__all__ = [
    "TraceSpec",
    "CompiledTrace",
    "KeyRealization",
    "KeyedEdgeTrace",
    "rate_ramp",
    "rate_burst",
    "rate_sine",
    "rate_noise",
    "machine_slowdown",
    "machine_removal",
    "machine_addition",
    "key_skew_shift",
    "ramp_trace",
    "burst_trace",
    "sine_trace",
    "slowdown_trace",
    "failure_trace",
    "skew_shift_trace",
    "elastic_trace",
]

# Child-stream tag for key realizations: keyed randomness draws from
# ``default_rng([seed, _KEY_STREAM])``, a stream independent of the rate /
# capacity event rng, so compiling the same spec with and without a keyed
# topology yields bit-identical rate and capacity arrays.
_KEY_STREAM = 0x6B6579  # "key"


def zipf_weights(n_keys: int, zipf_s: float) -> np.ndarray:
    """(K,) normalized Zipf key masses: ``p_k ∝ (k + 1) ** -zipf_s``."""
    w = (np.arange(1, n_keys + 1, dtype=np.float64)) ** (-float(zipf_s))
    return w / w.sum()


@dataclasses.dataclass(frozen=True)
class KeyRealization:
    """One drawn key population for a fields-grouped edge.

    ``weights[k]`` is key k's share of the edge's tuples (Zipf over the
    grouping's key space); ``hashes[k]`` is its drawn hash value. Key k is
    pinned to instance ``hashes[k] % n`` of the downstream component — the
    deterministic hash→instance map the executor, the cost model and the
    batch evaluator all share, so routing is a pure function of (realization,
    instance count).
    """

    edge: tuple[int, int]
    weights: np.ndarray  # (K,) non-negative, sums to 1
    hashes: np.ndarray   # (K,) int64 hash values >= 0

    def __post_init__(self) -> None:
        object.__setattr__(self, "edge", (int(self.edge[0]), int(self.edge[1])))
        object.__setattr__(
            self, "weights", np.asarray(self.weights, dtype=np.float64)
        )
        object.__setattr__(self, "hashes", np.asarray(self.hashes, dtype=np.int64))
        if self.weights.ndim != 1 or self.weights.shape != self.hashes.shape:
            raise ValueError("weights and hashes must be aligned 1-D arrays")
        if self.weights.size == 0 or np.any(self.weights < 0.0):
            raise ValueError("key weights must be non-empty and non-negative")
        if np.any(self.hashes < 0):
            raise ValueError("hash values must be non-negative")
        object.__setattr__(self, "_share_cache", {})

    def shares(self, n_instances: int) -> np.ndarray:
        """(n,) fraction of the edge's tuples landing on each downstream
        instance when the component runs ``n_instances`` instances."""
        n = int(n_instances)
        if n < 1:
            raise ValueError("need >= 1 downstream instance")
        cached = self._share_cache.get(n)
        if cached is None:
            cached = np.bincount(
                self.hashes % n, weights=self.weights, minlength=n
            )
            self._share_cache[n] = cached
        return cached

    @staticmethod
    def draw(
        edge: tuple[int, int], n_keys: int, zipf_s: float, rng: np.random.Generator
    ) -> "KeyRealization":
        """Draw a realization: Zipf weights + uniform random hash values
        (which instance a hot key lands on is seed-determined)."""
        return KeyRealization(
            edge=edge,
            weights=zipf_weights(n_keys, zipf_s),
            hashes=rng.integers(0, np.iinfo(np.int64).max, size=n_keys),
        )


@dataclasses.dataclass(frozen=True)
class KeyedEdgeTrace:
    """Per-window key routing of one fields edge: ordered realization
    segments ``(start_window, realization)``; segment i is active on
    windows ``[start_i, start_{i+1})``. Segment 0 always starts at 0."""

    edge: tuple[int, int]
    segments: tuple[tuple[int, KeyRealization], ...]

    def __post_init__(self) -> None:
        object.__setattr__(self, "edge", (int(self.edge[0]), int(self.edge[1])))
        object.__setattr__(
            self,
            "segments",
            tuple((int(s), r) for s, r in self.segments),
        )
        if not self.segments or self.segments[0][0] != 0:
            raise ValueError("keyed edge needs a realization from window 0")
        starts = [s for s, _ in self.segments]
        if starts != sorted(starts):
            raise ValueError("segments must be ordered by start window")

    def segment_index(self, window: int) -> int:
        return int(self.segment_indices(window + 1)[window])

    def segment_indices(self, n_windows: int) -> np.ndarray:
        """(W,) active-segment index per window — the single owner of the
        start-inclusive boundary rule; the executor's per-window routing
        and the batch evaluator's share grids both expand through it, so
        their bit-parity cannot drift."""
        starts = np.array([s for s, _ in self.segments], dtype=np.int64)
        return np.searchsorted(starts, np.arange(n_windows), side="right") - 1

    def realization_at(self, window: int) -> KeyRealization:
        return self.segments[self.segment_index(window)][1]


@dataclasses.dataclass(frozen=True)
class CompiledTrace:
    """Dense per-window arrays of one workload scenario.

    Attributes:
      name: scenario name (from the spec).
      window_s: window length in seconds (the event-loop dt).
      rates: (W,) offered topology input rate per window (tuples/s at each
        spout, the paper's R0 as a function of time).
      capacity: (W, m) per-machine CPU capacity per window; 0.0 = removed.
      events: (window, description) markers for capacity changes, for
        event logs and plots.
      seed: the seed the stochastic events were drawn with.
      keyed: per-window key routing for every fields-grouped edge of the
        topology the trace was compiled against (empty when compiled
        without a ``utg`` or for an all-shuffle topology).
    """

    name: str
    window_s: float
    rates: np.ndarray
    capacity: np.ndarray
    events: tuple[tuple[int, str], ...]
    seed: int
    keyed: tuple[KeyedEdgeTrace, ...] = ()

    @property
    def n_windows(self) -> int:
        return int(self.rates.shape[0])

    @property
    def n_machines(self) -> int:
        return int(self.capacity.shape[1])

    def skew_epoch(self, window: int) -> int:
        """Monotone counter that bumps whenever any keyed edge's active
        realization changes (a ``key_skew_shift`` boundary crossed)."""
        return sum(kt.segment_index(window) for kt in self.keyed)

    def realizations_at(self, window: int) -> dict[tuple[int, int], KeyRealization]:
        """Active realization per fields edge at ``window``."""
        return {kt.edge: kt.realization_at(window) for kt in self.keyed}


# ------------------------------------------------------------------ events


@dataclasses.dataclass(frozen=True)
class rate_ramp:
    """Linear rate ramp from the curve's value at ``start`` to ``to_rate``
    over [start, end); windows >= end hold ``to_rate`` (the paper's gradual
    rate increase protocol)."""

    to_rate: float
    start: int = 0
    end: int | None = None

    def apply(self, rates: np.ndarray, capacity: np.ndarray, rng) -> list:
        W = rates.shape[0]
        end = W if self.end is None else min(self.end, W)
        if end > self.start:
            span = end - self.start
            rates[self.start : end] = np.linspace(
                rates[self.start], self.to_rate, span
            )
            rates[end:] = self.to_rate
        return []


@dataclasses.dataclass(frozen=True)
class rate_burst:
    """Multiplicative bursts: every ``every`` windows from ``start``, the
    rate is multiplied by ``factor`` for ``width`` windows. ``jitter``
    shifts each burst start by a seeded uniform integer in [-jitter, jitter]."""

    factor: float = 3.0
    every: int = 40
    width: int = 5
    start: int = 0
    jitter: int = 0

    def apply(self, rates: np.ndarray, capacity: np.ndarray, rng) -> list:
        W = rates.shape[0]
        for s in range(self.start, W, self.every):
            if self.jitter:
                s += int(rng.integers(-self.jitter, self.jitter + 1))
            lo, hi = max(s, 0), min(max(s, 0) + self.width, W)
            rates[lo:hi] *= self.factor
        return []


@dataclasses.dataclass(frozen=True)
class rate_sine:
    """Sinusoidal drift: ``rate *= 1 + amplitude * sin(2*pi*(t-start)/period)``
    for windows t >= start (clipped at zero)."""

    amplitude: float = 0.5
    period: int = 60
    start: int = 0

    def apply(self, rates: np.ndarray, capacity: np.ndarray, rng) -> list:
        W = rates.shape[0]
        t = np.arange(W - self.start, dtype=np.float64)
        wave = 1.0 + self.amplitude * np.sin(2.0 * np.pi * t / self.period)
        rates[self.start :] *= np.clip(wave, 0.0, None)
        return []


@dataclasses.dataclass(frozen=True)
class rate_noise:
    """Seeded multiplicative log-normal rate noise (sigma = ``scale``)."""

    scale: float = 0.05

    def apply(self, rates: np.ndarray, capacity: np.ndarray, rng) -> list:
        rates *= np.exp(rng.normal(0.0, self.scale, size=rates.shape))
        return []


@dataclasses.dataclass(frozen=True)
class machine_slowdown:
    """Machine ``machine`` runs at ``factor`` of its capacity in
    [start, end) (end=None -> until the trace ends)."""

    machine: int
    factor: float = 0.5
    start: int = 0
    end: int | None = None

    def apply(self, rates: np.ndarray, capacity: np.ndarray, rng) -> list:
        W = capacity.shape[0]
        end = W if self.end is None else min(self.end, W)
        capacity[self.start : end, self.machine] *= self.factor
        return [
            (self.start, f"slowdown m{self.machine} x{self.factor}"),
            *([(end, f"recover m{self.machine}")] if end < W else []),
        ]


@dataclasses.dataclass(frozen=True)
class machine_removal:
    """Machine ``machine`` is removed (capacity 0) in [start, end)."""

    machine: int
    start: int = 0
    end: int | None = None

    def apply(self, rates: np.ndarray, capacity: np.ndarray, rng) -> list:
        W = capacity.shape[0]
        end = W if self.end is None else min(self.end, W)
        capacity[self.start : end, self.machine] = 0.0
        return [
            (self.start, f"remove m{self.machine}"),
            *([(end, f"restore m{self.machine}")] if end < W else []),
        ]


@dataclasses.dataclass(frozen=True)
class machine_addition:
    """Machine ``machine`` joins the cluster at ``start`` (cloud scale-out).

    The cluster passed to ``TraceSpec.compile`` is the *fleet* — every
    machine that could ever serve, provisioned or not. An added machine's
    capacity column is 0 before ``start`` (the dense grid gains a column
    that switches on mid-trace) and its nominal capacity — or the
    ``capacity`` override — on [start, end). ``end`` models a leased
    machine returned to the provider. Pair with
    ``RuntimeConfig(capacity_notice=...)`` so controllers can also *drain*
    ahead of the lease expiring instead of losing the instances with it.
    """

    machine: int
    start: int
    end: int | None = None
    capacity: float | None = None

    def apply(self, rates: np.ndarray, capacity: np.ndarray, rng) -> list:
        W = capacity.shape[0]
        end = W if self.end is None else min(self.end, W)
        val = (
            float(self.capacity)
            if self.capacity is not None
            else float(capacity[min(self.start, W - 1), self.machine])
        )
        capacity[: self.start, self.machine] = 0.0
        capacity[self.start : end, self.machine] = val
        capacity[end:, self.machine] = 0.0
        return [
            (self.start, f"add m{self.machine}"),
            *([(end, f"remove m{self.machine}")] if end < W else []),
        ]


@dataclasses.dataclass(frozen=True)
class key_skew_shift:
    """Re-draw the key population of fields-grouped edges at ``start``.

    Models key-distribution drift in keyed streams: the hot keys move (new
    seeded hash draw) and optionally the skew exponent changes
    (``zipf_s``). ``edge=None`` shifts every fields edge. Requires the
    trace to be compiled against a keyed topology
    (``TraceSpec.compile(..., utg=...)``).
    """

    start: int
    edge: tuple[int, int] | None = None
    zipf_s: float | None = None

    def apply(self, rates: np.ndarray, capacity: np.ndarray, rng) -> list:
        # Rate/capacity are untouched; the keyed pass in ``compile``
        # consumes this event (and emits its markers) separately.
        return []


# -------------------------------------------------------------------- spec


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """A workload scenario: base rate + ordered composable events.

    ``n_windows`` fixed-length windows of ``window_s`` seconds each; the
    offered rate starts flat at ``base_rate`` and each event transforms the
    rate curve and/or the capacity grid in declaration order.
    """

    name: str
    n_windows: int
    base_rate: float
    events: tuple = ()
    window_s: float = 1.0

    def compile(
        self, cluster: Cluster, seed: int = 0, utg: UserGraph | None = None
    ) -> CompiledTrace:
        """Lower to dense (W,) rate and (W, m) capacity arrays.

        All randomness (burst jitter, noise, key populations) is drawn here
        from ``default_rng(seed)`` — the compiled trace is a pure value and
        every consumer of it is deterministic. ``utg`` supplies the
        fields-grouped edges whose key realizations the trace must carry;
        keyed randomness draws from an independent child stream, so the
        rate/capacity arrays are bit-identical with or without it.
        """
        if self.n_windows < 1:
            raise ValueError("trace needs at least one window")
        rng = np.random.default_rng(seed)
        rates = np.full(self.n_windows, float(self.base_rate), dtype=np.float64)
        capacity = np.tile(cluster.capacity, (self.n_windows, 1)).astype(np.float64)
        markers: list[tuple[int, str]] = []
        for ev in self.events:
            markers.extend(ev.apply(rates, capacity, rng))
        keyed, key_markers = self._compile_keyed(utg, seed)
        markers.extend(key_markers)
        np.clip(rates, 0.0, None, out=rates)
        np.clip(capacity, 0.0, None, out=capacity)
        return CompiledTrace(
            name=self.name,
            window_s=float(self.window_s),
            rates=rates,
            capacity=capacity,
            events=tuple(sorted(markers)),
            seed=seed,
            keyed=keyed,
        )

    def _compile_keyed(
        self, utg: UserGraph | None, seed: int
    ) -> tuple[tuple[KeyedEdgeTrace, ...], list[tuple[int, str]]]:
        """Draw every fields edge's key realization segments.

        Draw order is deterministic: one initial realization per grouping
        (declaration order), then one re-draw per (shift event, matched
        edge) in declaration order — so the initial population for a given
        (utg, seed) is identical across specs regardless of their events.
        """
        shifts = [ev for ev in self.events if isinstance(ev, key_skew_shift)]
        groupings = () if utg is None else utg.groupings
        if not groupings:
            if shifts:
                raise ValueError(
                    "key_skew_shift requires a keyed topology "
                    "(compile with utg=... and fields groupings)"
                )
            return (), []
        rng = np.random.default_rng(np.random.SeedSequence([seed, _KEY_STREAM]))
        segments: dict[tuple[int, int], list[tuple[int, KeyRealization]]] = {}
        exponent: dict[tuple[int, int], float] = {}
        for g in groupings:
            segments[g.edge] = [(0, KeyRealization.draw(g.edge, g.n_keys, g.zipf_s, rng))]
            exponent[g.edge] = g.zipf_s
        markers: list[tuple[int, str]] = []
        by_edge = {g.edge: g for g in groupings}
        for ev in shifts:
            edges = list(by_edge) if ev.edge is None else [tuple(ev.edge)]
            for edge in edges:
                if edge not in by_edge:
                    raise ValueError(f"key_skew_shift on non-fields edge {edge}")
                s = exponent[edge] if ev.zipf_s is None else float(ev.zipf_s)
                exponent[edge] = s
                real = KeyRealization.draw(edge, by_edge[edge].n_keys, s, rng)
                if 0 <= ev.start < self.n_windows:
                    segments[edge].append((int(ev.start), real))
                    markers.append(
                        (int(ev.start), f"key_skew_shift e{edge[0]}->{edge[1]} s={s:g}")
                    )
        keyed = tuple(
            KeyedEdgeTrace(
                edge=g.edge,
                segments=tuple(sorted(segments[g.edge], key=lambda t: t[0])),
            )
            for g in groupings
        )
        return keyed, markers


# ------------------------------------------------------- stock scenarios


def ramp_trace(
    lo_rate: float, hi_rate: float, n_windows: int = 240, hold: int = 20
) -> TraceSpec:
    """The paper's gradual rate-ramp protocol: hold ``lo_rate`` for
    ``hold`` windows, ramp linearly to ``hi_rate``, then hold."""
    return TraceSpec(
        name="ramp",
        n_windows=n_windows,
        base_rate=lo_rate,
        events=(rate_ramp(hi_rate, start=hold, end=n_windows - hold),),
    )


def burst_trace(
    base_rate: float,
    factor: float = 3.0,
    n_windows: int = 240,
    every: int = 48,
    width: int = 8,
    jitter: int = 3,
) -> TraceSpec:
    """Periodic rate bursts with seeded start jitter."""
    return TraceSpec(
        name="burst",
        n_windows=n_windows,
        base_rate=base_rate,
        events=(rate_burst(factor, every=every, width=width, start=16, jitter=jitter),),
    )


def sine_trace(
    mean_rate: float, amplitude: float = 0.5, n_windows: int = 240, period: int = 80
) -> TraceSpec:
    """Sinusoidal diurnal-style drift around ``mean_rate``."""
    return TraceSpec(
        name="sine",
        n_windows=n_windows,
        base_rate=mean_rate,
        events=(rate_sine(amplitude, period=period),),
    )


def slowdown_trace(
    rate: float, machine: int, factor: float = 0.5, n_windows: int = 240
) -> TraceSpec:
    """Constant rate; ``machine`` slows to ``factor`` capacity a third of
    the way in (resource churn without failure)."""
    return TraceSpec(
        name="slowdown",
        n_windows=n_windows,
        base_rate=rate,
        events=(machine_slowdown(machine, factor, start=n_windows // 3),),
    )


def failure_trace(rate: float, machine: int, n_windows: int = 240) -> TraceSpec:
    """Constant rate; ``machine`` is removed a third of the way in."""
    return TraceSpec(
        name="failure",
        n_windows=n_windows,
        base_rate=rate,
        events=(machine_removal(machine, start=n_windows // 3),),
    )


def elastic_trace(
    lo_rate: float,
    hi_rate: float,
    machine: int,
    n_windows: int = 240,
    join: int | None = None,
) -> TraceSpec:
    """Cloud scale-out: the offered rate ramps past what the initial
    machines sustain, and spare ``machine`` joins a third of the way in
    (default) — only a controller that grows onto the new column rides the
    ramp; a frozen schedule saturates at the old fleet's bound."""
    join = n_windows // 3 if join is None else join
    return TraceSpec(
        name="elastic",
        n_windows=n_windows,
        base_rate=lo_rate,
        events=(
            rate_ramp(hi_rate, start=20, end=n_windows - 40),
            machine_addition(machine, start=join),
        ),
    )


def skew_shift_trace(
    rate: float, n_windows: int = 240, zipf_s: float | None = None
) -> TraceSpec:
    """Constant rate on a keyed topology; the key population of every
    fields edge re-draws a third of the way in (hot keys move, optionally
    to a new skew exponent) — rate and capacity never change, so only a
    skew-aware controller sees the drift."""
    return TraceSpec(
        name="skew_shift",
        n_windows=n_windows,
        base_rate=rate,
        events=(key_skew_shift(start=n_windows // 3, zipf_s=zipf_s),),
    )
