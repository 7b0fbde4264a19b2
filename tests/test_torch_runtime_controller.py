"""Port parity: the online controllers and ``provision_schedule``.

The controller scenarios of the reference's runtime and state-migration
tests (failure, ramp, guard, migration pause, keyed hot instance, skew
shift, noisy observations, scale-out, drain, the guard's pause and state
pricing, the oracle), at W <= 120 windows on the paper's small clusters,
run through both packages: the port's controllers replan with
``refine(device="cpu")`` and must give the reference's fingerprints, replan
ledgers (``to_records()``) and legacy logs exactly.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.runtime_stream as RS  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.runtime_stream as PS  # noqa: E402
from repro_torch.core import convert  # noqa: E402


def _rate(M, topo, cluster):
    """The refined rate of ``topo`` on ``cluster`` (reference side)."""
    etg = M.schedule(topo, cluster, r0=1.0, rate_epsilon=0.05).etg
    return R.refine(etg, cluster)


@pytest.fixture(scope="module")
def small():
    ref = R.paper_cluster((1, 1, 1))
    refined = _rate(R, R.linear_topology(), ref)
    ref_keyed = R.keyed_rolling_count_topology(n_keys=16, zipf_s=1.5)
    keyed_etg = R.schedule(ref_keyed, ref, r0=1.0, rate_epsilon=0.05).etg
    probe = RS.StreamExecutor(keyed_etg, ref, RS.TraceSpec(name="probe", n_windows=2,
                                                           base_rate=1.0), seed=5)
    r_skew, _ = R.max_stable_rate(keyed_etg, ref, skew=probe.skew_model_at(0))
    r_even, _ = R.max_stable_rate(keyed_etg, ref)
    ref_state = R.keyed_rolling_count_topology(n_keys=16, zipf_s=1.5, state_per_tuple=25.0)
    state_etg = R.schedule(ref_state, ref, r0=1.0, rate_epsilon=0.05).etg
    fleet = R.paper_cluster((1, 1, 2))
    r4 = _rate(R, R.linear_topology(), fleet).rate
    return dict(cluster=ref, refined=refined, keyed_etg=keyed_etg, r_skew=r_skew,
                r_even=r_even, state_etg=state_etg, fleet=fleet, r4=r4)


def _scenario(name, s):
    """(start etg, cluster, spec builder, executor kwargs, controller
    builder) of one scenario, reference objects; the builders take the
    package."""
    rate = s["refined"].rate
    lin = R.linear_topology()
    mq = lambda S: S.RuntimeConfig(max_queue=120.0)  # noqa: E731
    if name == "failure":
        return (s["refined"].etg, s["cluster"],
                lambda S: S.failure_trace(rate * 0.85, machine=2, n_windows=120), {},
                lambda S, u, cl, **kw: S.OnlineController(u, cl, period=6, **kw))
    if name in ("ramp", "ramp, migration pause 3", "ramp, adaptive growth"):
        prov = RS.provision_schedule(lin, s["cluster"], rate * 0.3)
        cfg = (lambda S: S.RuntimeConfig(migration_pause=3)) if "pause" in name else None
        adaptive = "adaptive" in name
        return (prov, s["cluster"], lambda S: S.ramp_trace(rate * 0.3, rate * 1.2, n_windows=120),
                {} if cfg is None else {"config": cfg},
                lambda S, u, cl, **kw: S.OnlineController(u, cl, period=10,
                                                          adaptive_growth=adaptive, **kw))
    if name == "guard":
        return (s["refined"].etg, s["cluster"],
                lambda S: S.TraceSpec(name="flat", n_windows=80, base_rate=rate * 0.5), {},
                lambda S, u, cl, **kw: S.OnlineController(u, cl, period=8, **kw))
    if name == "noisy, flat":
        return (s["refined"].etg, s["cluster"],
                lambda S: S.TraceSpec(name="flat", n_windows=120, base_rate=rate * 0.5), {},
                lambda S, u, cl, **kw: S.OnlineController(u, cl, period=8, measure_noise=0.05,
                                                          noise_seed=7, **kw))
    if name == "noisy, failure":
        return (s["refined"].etg, s["cluster"],
                lambda S: S.failure_trace(rate * 0.85, machine=2, n_windows=120), {},
                lambda S, u, cl, **kw: S.OnlineController(u, cl, period=6, measure_noise=0.05,
                                                          **kw))
    if name == "keyed hot instance":
        return (s["keyed_etg"], s["cluster"],
                lambda S: S.TraceSpec(name="hotkeys", n_windows=120, base_rate=0.95 * s["r_even"]),
                {"seed": 5, "config": mq},
                lambda S, u, cl, **kw: S.OnlineController(u, cl, period=10, **kw))
    if name == "skew shift":
        return (s["keyed_etg"], s["cluster"],
                lambda S: S.skew_shift_trace(0.7 * s["r_skew"], n_windows=120),
                {"seed": 11, "config": mq},
                lambda S, u, cl, **kw: S.OnlineController(u, cl, period=8, **kw))
    if name in ("state, long pauses", "state, free restarts", "state, budget",
                "state, priced", "state-blind"):
        cfg = {"state, long pauses": dict(max_queue=120.0, migration_pause=40),
               "state, free restarts": dict(max_queue=120.0, migration_pause=0)}.get(
            name, dict(max_queue=120.0, state_transfer_rate=50.0))
        ctl_kw = {"state, budget": dict(elastic_budget=0.0),
                  "state-blind": dict(state_aware=False)}.get(name, {})
        r_even, _ = R.max_stable_rate(s["state_etg"], s["cluster"])
        return (s["state_etg"], s["cluster"],
                lambda S: S.TraceSpec(name="hotkeys", n_windows=120, base_rate=0.95 * r_even),
                {"seed": 5, "config": lambda S: S.RuntimeConfig(**cfg)},
                lambda S, u, cl, **kw: S.OnlineController(u, cl, period=10, horizon_windows=60,
                                                          **ctl_kw, **kw))
    if name == "scale-out":
        r3 = rate
        start = RS.provision_schedule(lin, s["cluster"], 0.5 * r3)
        return (start, s["fleet"],
                lambda S: S.elastic_trace(0.5 * r3, 1.05 * s["r4"], machine=3, n_windows=120,
                                          join=70),
                {"config": mq}, lambda S, u, cl, **kw: S.OnlineController(u, cl, period=10, **kw))
    if name == "drain":
        start = RS.provision_schedule(lin, s["cluster"], 1.35 * rate)
        return (start, s["fleet"],
                lambda S: S.TraceSpec(name="lease", n_windows=120, base_rate=1.35 * rate,
                                      events=(S.machine_addition(3, start=10, end=85),)),
                {"config": lambda S: S.RuntimeConfig(max_queue=120.0, capacity_notice=25)},
                lambda S, u, cl, **kw: S.OnlineController(u, cl, period=10, **kw))
    if name == "oracle, skew shift":
        return (s["keyed_etg"], s["cluster"], lambda S: S.skew_shift_trace(1.0, n_windows=120),
                {"seed": 7, "config": lambda S: S.RuntimeConfig(migration_pause=0)},
                lambda S, u, cl, **kw: S.OracleRescheduler(u, cl, **kw))
    if name == "oracle, failure":
        return (s["refined"].etg, s["cluster"],
                lambda S: S.failure_trace(rate * 0.85, machine=2, n_windows=60), {},
                lambda S, u, cl, **kw: S.OracleRescheduler(u, cl, **kw))
    raise KeyError(name)


SCENARIOS = ["failure", "ramp", "ramp, migration pause 3", "ramp, adaptive growth", "guard",
             "noisy, flat", "noisy, failure", "keyed hot instance", "skew shift",
             "state, long pauses", "state, free restarts", "state, budget", "state, priced",
             "state-blind", "scale-out", "drain", "oracle, skew shift", "oracle, failure"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_controller_run_matches_reference(small, name):
    ref_etg, ref_cluster, spec, ex_kw, make = _scenario(name, small)
    utg = convert.user_graph(ref_etg.utg)
    etg = convert.execution_graph(ref_etg, utg)
    cluster = convert.cluster(ref_cluster)

    def kwargs(S):
        return {k: (v(S) if callable(v) else v) for k, v in ex_kw.items()}

    ref_ctl = make(RS, ref_etg.utg, ref_cluster)
    want = RS.StreamExecutor(ref_etg, ref_cluster, spec(RS), **kwargs(RS)).run(ref_ctl)
    ctl = make(PS, utg, cluster, device="cpu")
    got = PS.StreamExecutor(etg, cluster, spec(PS), **kwargs(PS)).run(ctl)
    assert got.fingerprint() == want.fingerprint()
    assert got.events == want.events
    assert np.array_equal(got.final_etg.task_machine(), want.final_etg.task_machine())
    if isinstance(ref_ctl, RS.OnlineController):
        assert ctl.ledger.to_records() == ref_ctl.ledger.to_records()
        assert ctl.log == ref_ctl.log
        assert [d.accepted for d in ctl.ledger] == [d.accepted for d in ref_ctl.ledger]
    else:
        assert sorted(ctl._cache) == sorted(ref_ctl._cache)


def test_scenarios_exercise_their_triggers(small):
    """The reduced scenarios still reach the decisions they are named for."""
    seen = {}
    for name in ("scale-out", "drain", "state, long pauses", "state, budget", "skew shift"):
        ref_etg, ref_cluster, spec, ex_kw, make = _scenario(name, small)
        ctl = make(RS, ref_etg.utg, ref_cluster)
        kw = {k: (v(RS) if callable(v) else v) for k, v in ex_kw.items()}
        RS.StreamExecutor(ref_etg, ref_cluster, spec(RS), **kw).run(ctl)
        seen[name] = {why.split(" ")[0] for _, why in ctl.log}
    assert "scale_out:replan" in seen["scale-out"]
    assert "drain:replan" in seen["drain"]
    assert any(w.endswith(":skip") for w in seen["state, long pauses"])
    assert any(w.endswith(":budget") for w in seen["state, budget"])
    assert any(w.startswith("skew_shift") for w in seen["skew shift"])


@pytest.mark.parametrize("topology", ["linear", "diamond", "star"])
@pytest.mark.parametrize("fraction", [0.01, 0.3, 1.0, 2.0])
def test_provision_schedule_matches_reference(small, topology, fraction):
    ref_cluster = R.paper_cluster((2, 2, 2))
    ref_topo = getattr(R, f"{topology}_topology")()
    rate = fraction * _rate(R, ref_topo, ref_cluster).rate
    want = RS.provision_schedule(ref_topo, ref_cluster, rate)
    got = PS.provision_schedule(convert.user_graph(ref_topo), convert.cluster(ref_cluster), rate)
    assert np.array_equal(got.n_instances, want.n_instances)
    assert np.array_equal(got.task_machine(), want.task_machine())


def test_controllers_pass_their_device_to_refine(small, monkeypatch):
    """Every ``refine`` a controller runs gets its ``device``."""
    import repro_torch.runtime_stream.controller as C

    devices = []
    real = C.refine

    def spy(*args, **kwargs):
        devices.append(kwargs.get("device"))
        return real(*args, **kwargs)

    monkeypatch.setattr(C, "refine", spy)
    for name in ("failure", "oracle, skew shift"):
        ref_etg, ref_cluster, spec, ex_kw, make = _scenario(name, small)
        utg = convert.user_graph(ref_etg.utg)
        cluster = convert.cluster(ref_cluster)
        kw = {k: (v(PS) if callable(v) else v) for k, v in ex_kw.items()}
        PS.StreamExecutor(convert.execution_graph(ref_etg, utg), cluster, spec(PS), **kw).run(
            make(PS, utg, cluster, device="cpu"))
    assert devices and all(str(d) == "cpu" for d in devices)
