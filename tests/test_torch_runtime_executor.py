"""Port parity: the streaming executor and its migration accounting.

``repro_torch.runtime_stream.StreamExecutor`` keeps the reference's window
step formula for formula, with ``np.bincount`` for the per-machine and
per-component sums, so its runs are bit-identical: the four shuffle
fingerprints the reference pins come out of the port unchanged (scheduled
through the port's ``schedule`` / ``refine(device="cpu")``), and keyed runs,
background load and migration pauses (flat and state-transfer) give the
reference's fingerprints. ``placement_migrations``, ``placement_transfer``
and ``transfer_pause_windows`` agree exactly.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.runtime_stream as RS  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.runtime_stream as PS  # noqa: E402
from repro_torch.core import convert  # noqa: E402

# The reference's pinned shuffle fingerprints
# (tests/test_runtime_stream.py::_SHUFFLE_GOLDEN_FPS).
SHUFFLE_GOLDEN_FPS = {
    ("linear", "burst"): "26fc286367d2ab03eba1c45d9417a04b",
    ("linear", "ramp"): "ca9542d22a245bc90ba588543f47f041",
    ("rolling_count", "burst"): "2b6e1b64c419dd53f37337ab3c5e45e3",
    ("rolling_count", "ramp"): "c160b175553ae57f70c3e0a9cdf263eb",
}


@pytest.fixture(scope="module")
def clusters():
    ref = R.paper_cluster((1, 1, 1))
    return ref, convert.cluster(ref)


@pytest.mark.parametrize("topology", ["linear", "rolling_count"])
@pytest.mark.parametrize("scenario", ["burst", "ramp"])
def test_pinned_shuffle_fingerprints(clusters, topology, scenario):
    _, cluster = clusters
    topo = {"linear": P.linear_topology, "rolling_count": P.rolling_count_topology}[topology]()
    full = P.refine(P.schedule(topo, cluster, r0=1.0, rate_epsilon=0.05).etg, cluster,
                    device="cpu")
    if scenario == "burst":
        run = PS.StreamExecutor(full.etg, cluster,
                                PS.burst_trace(full.rate * 0.8, n_windows=100, jitter=4), seed=11)
    else:
        run = PS.StreamExecutor(full.etg, cluster,
                                PS.ramp_trace(0.3 * full.rate, 1.5 * full.rate, n_windows=120),
                                seed=3)
    assert run.run().fingerprint() == SHUFFLE_GOLDEN_FPS[(topology, scenario)]


def assert_same_run(got, want):
    """The port's ``RuntimeResult`` equals the reference's bit for bit."""
    assert got.fingerprint() == want.fingerprint()
    for field in ("offered", "admitted", "throughput", "dropped", "queue_total", "queue_max",
                  "machine_util", "throttle", "migrations"):
        assert np.array_equal(getattr(got, field), getattr(want, field)), field
    assert got.events == want.events
    assert np.array_equal(got.latency(), want.latency())
    assert got.latency_slo_frac(2.0) == want.latency_slo_frac(2.0)
    assert got.sustained_throughput(0.3) == want.sustained_throughput(0.3)


@pytest.fixture(scope="module")
def keyed(clusters):
    """Stateful keyed topology, its schedule in both packages and the
    skew-aware rates."""
    ref_cluster, _ = clusters
    ref_utg = R.keyed_rolling_count_topology(n_keys=16, zipf_s=1.5, state_per_tuple=25.0)
    ref_etg = R.schedule(ref_utg, ref_cluster, r0=1.0, rate_epsilon=0.05).etg
    utg = convert.user_graph(ref_utg)
    etg = convert.execution_graph(ref_etg, utg)
    r_even, _ = R.max_stable_rate(ref_etg, ref_cluster)
    return ref_utg, ref_etg, utg, etg, r_even


def _both(clusters, keyed_setup, build, **kw):
    """Run ``build(S)``'s spec on the keyed schedule in both packages."""
    ref_cluster, cluster = clusters
    _, ref_etg, _, etg, _ = keyed_setup
    ref_kw = {k: (v(RS) if callable(v) else v) for k, v in kw.items()}
    port_kw = {k: (v(PS) if callable(v) else v) for k, v in kw.items()}
    want = RS.StreamExecutor(ref_etg, ref_cluster, build(RS), **ref_kw).run()
    got = PS.StreamExecutor(etg, cluster, build(PS), **port_kw).run()
    return got, want


@pytest.mark.parametrize("case", ["under", "over", "skew shift", "keyed ramp"])
def test_keyed_runs_match_reference(clusters, keyed, case):
    r_even = keyed[4]
    specs = {
        "under": lambda S: S.TraceSpec(name="under", n_windows=80, base_rate=0.4 * r_even),
        "over": lambda S: S.TraceSpec(name="over", n_windows=120, base_rate=0.95 * r_even),
        "skew shift": lambda S: S.skew_shift_trace(0.8 * r_even, n_windows=120),
        "keyed ramp": lambda S: S.ramp_trace(0.2 * r_even, 1.3 * r_even, n_windows=100),
    }
    got, want = _both(clusters, keyed, specs[case], seed=5,
                      config=lambda S: S.RuntimeConfig(max_queue=120.0))
    assert_same_run(got, want)


@pytest.mark.parametrize("shape", ["(m,)", "(W, m)"])
def test_background_load_matches_reference(clusters, keyed, shape):
    r_even = keyed[4]
    m, W = clusters[0].n_machines, 90
    rng = np.random.default_rng(3)
    bg = rng.uniform(0.0, 0.4, size=m if shape == "(m,)" else (W, m)) * clusters[0].capacity
    got, want = _both(clusters, keyed,
                      lambda S: S.burst_trace(0.6 * r_even, n_windows=W, jitter=2),
                      seed=2, background_load=bg)
    assert_same_run(got, want)


class Scripted:
    """A controller that hands the executor fixed placements at fixed
    windows (no drift logic), so the executor's migration path is held
    alone."""

    def __init__(self, plans, period=5):
        self.plans = dict(plans)
        self.period = period

    def update(self, obs):
        return self.plans.get(obs.window)


def _plans(ref_cluster, ref_etg, ref_skew):
    """Three replans of the keyed schedule: a relocation by ``refine``, a
    resize of the keyed component (it rehashes), and the way back."""
    moved = R.refine(ref_etg, ref_cluster, max_rounds=3, skew=ref_skew).etg
    c = max(ref_skew.keyed_components)
    n_inst = ref_etg.n_instances.copy()
    n_inst[c] += 1
    grown = R.ExecutionGraph(
        utg=ref_etg.utg, n_instances=n_inst,
        assignment=[np.concatenate([a, a[:1]]) if i == c else a.copy()
                    for i, a in enumerate(ref_etg.assignment)])
    return {9: moved, 24: grown, 44: ref_etg}


@pytest.mark.parametrize("transfer_rate", [float("inf"), 40.0])
@pytest.mark.parametrize("pause", [1, 3])
def test_migration_and_state_transfer_pauses_match_reference(clusters, keyed, transfer_rate,
                                                            pause):
    ref_cluster, cluster = clusters
    ref_utg, ref_etg, utg, etg, r_even = keyed
    spec = dict(name="hot", n_windows=70, base_rate=0.9 * r_even)
    ref_ex = RS.StreamExecutor(ref_etg, ref_cluster, RS.TraceSpec(**spec), seed=5,
                               config=RS.RuntimeConfig(max_queue=120.0, migration_pause=pause,
                                                       state_transfer_rate=transfer_rate))
    plans = _plans(ref_cluster, ref_etg, ref_ex.skew_model_at(0))
    want = ref_ex.run(controller=Scripted(plans))
    ex = PS.StreamExecutor(etg, cluster, PS.TraceSpec(**spec), seed=5,
                           config=PS.RuntimeConfig(max_queue=120.0, migration_pause=pause,
                                                   state_transfer_rate=transfer_rate))
    got = ex.run(controller=Scripted({w: convert.execution_graph(e, utg)
                                      for w, e in plans.items()}))
    assert want.migrations.sum() > 0
    assert_same_run(got, want)
    assert np.array_equal(got.final_etg.task_machine(), want.final_etg.task_machine())


def test_transfer_accounting_matches_reference(clusters, keyed):
    ref_cluster, cluster = clusters
    ref_utg, ref_etg, utg, etg, _ = keyed
    ref_skew = RS.StreamExecutor(ref_etg, ref_cluster, RS.TraceSpec(
        name="probe", n_windows=2, base_rate=1.0), seed=5).skew_model_at(0)
    skew = PS.StreamExecutor(etg, cluster, PS.TraceSpec(
        name="probe", n_windows=2, base_rate=1.0), seed=5).skew_model_at(0)
    lin = R.schedule(R.linear_topology(), ref_cluster, r0=1.0, rate_epsilon=0.05).etg
    pairs = [(ref_etg, new, s) for new in _plans(ref_cluster, ref_etg, ref_skew).values()
             for s in (True, False)]
    pairs += [(lin, R.refine(lin, ref_cluster, max_rounds=k).etg, False) for k in (1, 4)]
    pairs.append((lin, lin.with_new_instance(3, 0), False))
    for old, new, with_skew in pairs:
        p_old = convert.execution_graph(old, utg if old.utg is ref_utg else None)
        p_new = convert.execution_graph(new, p_old.utg)
        want = RS.placement_transfer(old, new, skew=ref_skew if with_skew else None)
        got = PS.placement_transfer(p_old, p_new, skew=skew if with_skew else None)
        assert got.moves == want.moves and got.state_shipped == want.state_shipped
        assert np.array_equal(got.migrated, want.migrated)
        assert np.array_equal(got.instance_state, want.instance_state)
        assert PS.placement_migrations(p_old, p_new) == RS.placement_migrations(old, new)
        for rate in (float("inf"), 10.0, 0.5):
            for dt in (1.0, 0.25):
                assert np.array_equal(
                    PS.transfer_pause_windows(got, PS.RuntimeConfig(migration_pause=2,
                                                                    state_transfer_rate=rate), dt),
                    RS.transfer_pause_windows(want, RS.RuntimeConfig(migration_pause=2,
                                                                     state_transfer_rate=rate), dt))


def _error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_executor_validation_matches_reference(clusters, keyed):
    ref_cluster, cluster = clusters
    ref_utg, ref_etg, utg, etg, _ = keyed
    cases = [
        lambda S, cl, e: S.StreamExecutor(e, cl, S.TraceSpec(name="plain", n_windows=20,
                                                             base_rate=1.0).compile(cl, seed=0)),
        lambda S, cl, e: S.StreamExecutor(e, cl, S.TraceSpec(name="x", n_windows=20,
                                                             base_rate=1.0),
                                          background_load=np.ones((3, 2))),
        lambda S, cl, e: S.StreamExecutor(e, cl, S.TraceSpec(name="x", n_windows=20,
                                                             base_rate=1.0).compile(
            cl.subcluster(np.arange(2)), seed=0, utg=e.utg)),
    ]
    for case in cases:
        assert _error(lambda: case(PS, cluster, etg)) == _error(
            lambda: case(RS, ref_cluster, ref_etg))


def test_recorder_waits_for_the_trace_recorder(clusters, keyed):
    """The executor and the controller take a ``TraceRecorder`` (ROADMAP
    A11 is ported): the run records into it and keeps its fingerprint."""
    from repro_torch.obs import NULL_RECORDER, TraceRecorder

    _, cluster = clusters
    etg = keyed[3]
    spec = PS.TraceSpec(name="x", n_windows=4, base_rate=1.0)
    rec = TraceRecorder(name="x")
    on = PS.StreamExecutor(etg, cluster, spec, recorder=rec).run()
    off = PS.StreamExecutor(etg, cluster, spec)
    assert off.recorder is NULL_RECORDER
    assert on.fingerprint() == off.run().fingerprint()
    assert rec.records[0]["name"] == "run_start"
    ctl = PS.OnlineController(etg.utg, cluster, recorder=rec, device="cpu")
    assert ctl.recorder is rec
