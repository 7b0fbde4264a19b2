"""Port parity: workload traces of the streaming runtime.

Every stock scenario, keyed trace, skew shift and machine addition compiles
in ``repro_torch.runtime_stream`` to the reference's arrays exactly: rates,
capacity grid, events, seed, and each fields edge's realization segments
(key weights and drawn hashes). Both draw from ``default_rng(seed)`` and the
keyed child stream ``SeedSequence([seed, 0x6B6579])``. Validation errors
match word for word.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.runtime_stream as RS  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.runtime_stream as PS  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.runtime_stream import convert as rconvert  # noqa: E402
from repro_torch.runtime_stream.traces import zipf_weights  # noqa: E402


def assert_same_trace(got, want):
    """``got`` (the port's) equals the reference's ``want``, array for array."""
    assert got.name == want.name and got.window_s == want.window_s and got.seed == want.seed
    assert np.array_equal(got.rates, want.rates) and got.rates.dtype == want.rates.dtype
    assert np.array_equal(got.capacity, want.capacity)
    assert got.events == want.events
    assert len(got.keyed) == len(want.keyed)
    for kg, kw in zip(got.keyed, want.keyed):
        assert kg.edge == kw.edge
        assert [s for s, _ in kg.segments] == [s for s, _ in kw.segments]
        for (_, rg), (_, rw) in zip(kg.segments, kw.segments):
            assert rg.edge == rw.edge
            assert np.array_equal(rg.weights, rw.weights)
            assert np.array_equal(rg.hashes, rw.hashes)
            for n in (1, 3, 7):
                assert np.array_equal(rg.shares(n), rw.shares(n))
    for w in (0, got.n_windows // 3, got.n_windows - 1):
        assert got.skew_epoch(w) == want.skew_epoch(w)


def _keyed(M):
    return M.keyed_rolling_count_topology(n_keys=16, zipf_s=1.5)


# (name, cluster sizes, topology or None, spec builder taking the package)
SCENARIOS = [
    ("ramp", (1, 1, 1), None, lambda S: S.ramp_trace(1.0, 8.0, n_windows=60)),
    ("burst", (1, 1, 1), None, lambda S: S.burst_trace(3.0, n_windows=100, jitter=4)),
    ("sine", (1, 1, 1), None, lambda S: S.sine_trace(3.0, n_windows=60)),
    ("slowdown", (2, 2, 2), None, lambda S: S.slowdown_trace(3.0, machine=2, n_windows=60)),
    ("failure", (2, 2, 2), None, lambda S: S.failure_trace(3.0, machine=5, n_windows=60)),
    ("elastic", (1, 1, 2), None, lambda S: S.elastic_trace(1.0, 6.0, machine=3, n_windows=90)),
    ("machine addition with end", (1, 1, 2), None, lambda S: S.TraceSpec(
        name="lease", n_windows=80, base_rate=2.0,
        events=(S.machine_addition(3, start=10, end=50, capacity=7.5),))),
    ("every event", (2, 2, 2), None, lambda S: S.TraceSpec(
        name="mix", n_windows=120, base_rate=4.0,
        events=(S.rate_ramp(8.0, start=10, end=60), S.rate_burst(2.0, every=30, width=4, jitter=2),
                S.rate_noise(0.05), S.rate_sine(0.3, period=40, start=5),
                S.machine_slowdown(1, 0.5, start=40, end=90), S.machine_removal(0, start=80)))),
    ("keyed flat", (1, 1, 1), _keyed, lambda S: S.TraceSpec(name="flat", n_windows=40,
                                                            base_rate=2.0)),
    ("keyed skew shift", (1, 1, 1), _keyed, lambda S: S.skew_shift_trace(2.0, n_windows=120)),
    ("keyed skew shift, new exponent", (1, 1, 1), _keyed,
     lambda S: S.skew_shift_trace(2.0, n_windows=90, zipf_s=0.8)),
    ("keyed, two shifts on one edge", (2, 2, 2), _keyed, lambda S: S.TraceSpec(
        name="shifts", n_windows=100, base_rate=2.0,
        events=(S.key_skew_shift(start=20, edge=(1, 2), zipf_s=2.0),
                S.rate_noise(0.1), S.key_skew_shift(start=70, edge=(1, 2)),
                S.key_skew_shift(start=500)))),
    ("keyed ramp", (1, 1, 1), _keyed, lambda S: S.ramp_trace(1.0, 5.0, n_windows=60)),
]


@pytest.mark.parametrize("name,sizes,topology,build", SCENARIOS, ids=[s[0] for s in SCENARIOS])
@pytest.mark.parametrize("seed", [0, 7])
def test_compiled_trace_equals_reference(name, sizes, topology, build, seed):
    ref_cluster = R.paper_cluster(sizes)
    cluster = convert.cluster(ref_cluster)
    ref_utg = None if topology is None else topology(R)
    utg = None if ref_utg is None else convert.user_graph(ref_utg)
    want = build(RS).compile(ref_cluster, seed=seed, utg=ref_utg)
    got = build(PS).compile(cluster, seed=seed, utg=utg)
    assert_same_trace(got, want)
    assert_same_trace(rconvert.compiled_trace(want), want)


def test_zipf_weights_and_realization_draw_match():
    from repro.runtime_stream.traces import zipf_weights as ref_zipf

    for n_keys, s in ((1, 1.0), (16, 1.5), (100, 0.0), (7, 2.5)):
        assert np.array_equal(zipf_weights(n_keys, s), ref_zipf(n_keys, s))
    got = PS.KeyRealization.draw((1, 2), 32, 1.2, np.random.default_rng(4))
    want = RS.KeyRealization.draw((1, 2), 32, 1.2, np.random.default_rng(4))
    assert np.array_equal(got.hashes, want.hashes) and np.array_equal(got.weights, want.weights)


def _error(fn):
    with pytest.raises((ValueError, TypeError)) as info:
        fn()
    return type(info.value), str(info.value)


VALIDATION = [
    ("no windows", lambda S, M, cl: S.TraceSpec(name="bad", n_windows=0,
                                                base_rate=1.0).compile(cl)),
    ("skew shift without a keyed topology", lambda S, M, cl: S.skew_shift_trace(
        1.0, n_windows=30).compile(cl, utg=M.linear_topology())),
    ("skew shift on a shuffle edge", lambda S, M, cl: S.TraceSpec(
        name="bad", n_windows=30, base_rate=1.0, events=(S.key_skew_shift(5, edge=(0, 1)),)
    ).compile(cl, utg=M.keyed_rolling_count_topology())),
    ("unaligned realization", lambda S, M, cl: S.KeyRealization((0, 1), np.ones(3), np.ones(2))),
    ("negative key weight", lambda S, M, cl: S.KeyRealization((0, 1), -np.ones(2), np.ones(2))),
    ("negative hash", lambda S, M, cl: S.KeyRealization((0, 1), np.ones(2), -np.ones(2))),
    ("no shares for zero instances", lambda S, M, cl: S.KeyRealization(
        (0, 1), np.ones(2), np.ones(2)).shares(0)),
    ("segments not from window 0", lambda S, M, cl: S.KeyedEdgeTrace(
        (0, 1), ((3, S.KeyRealization((0, 1), np.ones(2), np.ones(2))),))),
    ("segments out of order", lambda S, M, cl: S.KeyedEdgeTrace((0, 1), (
        (0, S.KeyRealization((0, 1), np.ones(2), np.ones(2))),
        (9, S.KeyRealization((0, 1), np.ones(2), np.ones(2))),
        (4, S.KeyRealization((0, 1), np.ones(2), np.ones(2)))))),
]


@pytest.mark.parametrize("name,call", VALIDATION, ids=[v[0] for v in VALIDATION])
def test_validation_errors_match_reference(name, call):
    ref_cluster = R.paper_cluster((1, 1, 1))
    want = _error(lambda: call(RS, R, ref_cluster))
    got = _error(lambda: call(PS, P, convert.cluster(ref_cluster)))
    assert got == want
