"""Port parity: the observability layer (``repro_torch.obs``).

For the same deterministic run the port's ``TraceRecorder`` records what
the reference's does: the JSONL export of the controlled run, of a keyed
``refine(recorder=)`` and of the multi-tenant runtime, with ``strip_wall``,
equals ``repro``'s under the one backend-name map (``chip_smoke.py``'s
``backend_map``: every value that names a backend or a device becomes
"numpy", and dispatch counters that then share a name are summed). The
port's own reruns are byte-identical, a recorder leaves every fingerprint
unchanged, ``validate`` accepts good exports and rejects malformed ones,
and the Chrome trace keeps its schema. The scenarios are
``tests/test_obs.py``'s, on the paper's small clusters.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.obs as RO  # noqa: E402
import repro.runtime_stream as RS  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.runtime_stream as PS  # noqa: E402
from repro.core.refine import refine as ref_refine  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    NULL_RECORDER,
    MetricsRegistry,
    ReplanDecision,
    ReplanLedger,
    TraceRecorder,
    summary,
    to_chrome_trace,
    to_jsonl,
)
from repro_torch.obs.validate import (  # noqa: E402
    main as validate_main,
    validate_chrome,
    validate_file,
    validate_jsonl,
)
from repro_torch.runtime_stream import convert as trace_convert  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
backend_map = chip_smoke.backend_map

# The reference's pinned shuffle fingerprints (tests/test_obs.py).
SHUFFLE_GOLDEN_FPS = {
    ("linear", "burst"): "26fc286367d2ab03eba1c45d9417a04b",
    ("linear", "ramp"): "ca9542d22a245bc90ba588543f47f041",
    ("rolling_count", "burst"): "2b6e1b64c419dd53f37337ab3c5e45e3",
    ("rolling_count", "ramp"): "c160b175553ae57f70c3e0a9cdf263eb",
}


@pytest.fixture(scope="module")
def small():
    ref = R.paper_cluster((1, 1, 1))
    full = ref_refine(R.schedule(R.linear_topology(), ref, r0=1.0, rate_epsilon=0.05).etg, ref)
    return ref, convert.cluster(ref), full


def _controlled_run(small, recorder=None, port=True, **ctl_kwargs):
    """``tests/test_obs.py``'s controlled run: an under-provisioned linear
    schedule under a rate ramp, replanned every 10 windows."""
    ref_cluster, cluster, full = small
    ref_topo = R.linear_topology()
    prov = RS.provision_schedule(ref_topo, ref_cluster, full.rate * 0.3)
    trace = RS.ramp_trace(0.3 * full.rate, 1.2 * full.rate, n_windows=160)
    if not port:
        ctl = RS.OnlineController(ref_topo, ref_cluster, period=10, recorder=recorder,
                                  **ctl_kwargs)
        res = RS.StreamExecutor(prov, ref_cluster, trace, seed=3, recorder=recorder).run(
            controller=ctl)
        return res, ctl
    utg = convert.user_graph(ref_topo)
    ctl = PS.OnlineController(utg, cluster, period=10, recorder=recorder, device="cpu",
                              **ctl_kwargs)
    compiled = trace_convert.compiled_trace(trace.compile(ref_cluster, 3))
    res = PS.StreamExecutor(convert.execution_graph(prov, utg), cluster, compiled,
                            recorder=recorder).run(controller=ctl)
    return res, ctl


def test_backend_map_names_only_backends():
    """The map rewrites the values that name a backend or a device, sums
    the dispatch counters it merges, and leaves everything else alone."""
    text = "".join(json.dumps(r, sort_keys=True, separators=(",", ":")) + "\n" for r in [
        {"type": "meta", "name": "x", "records": 3, "wall_clock": False},
        {"type": "dispatch", "name": "closed_form_dispatch", "cat": "dispatch", "window": 0,
         "ts": 1, "args": {"requested": "cpu", "backend": "cpu", "regime": "shared"}},
        {"type": "span", "name": "refine", "cat": "refine", "window": 0, "ts": 2, "dur": 1,
         "args": {"engine": "state", "backend": "cuda"}},
        {"type": "span", "name": "other", "cat": "x", "window": 0, "ts": 3, "dur": 1,
         "args": {"backend": "cuda"}},
        {"type": "metric", "name": "dispatch.shared.cpu", "kind": "counter", "value": 2.0,
         "count": 2},
        {"type": "metric", "name": "controller.guard_evals", "kind": "counter", "value": 1.0,
         "count": 1},
        {"type": "metric", "name": "dispatch.shared.cuda", "kind": "counter", "value": 3.0,
         "count": 3},
    ])
    out = [json.loads(line) for line in backend_map(text).splitlines()]
    assert out[1]["args"]["requested"] == out[1]["args"]["backend"] == "numpy"
    assert out[2]["args"]["backend"] == "numpy" and out[3]["args"]["backend"] == "cuda"
    assert [(r["name"], r.get("value")) for r in out[4:]] == [
        ("dispatch.shared.numpy", 5.0), ("controller.guard_evals", 1.0)]
    assert out[4]["count"] == 5
    assert backend_map(backend_map(text)) == backend_map(text)


@pytest.mark.parametrize("topology", ["linear", "rolling_count"])
def test_recorder_on_keeps_pinned_fingerprints(small, topology):
    _, cluster, _ = small
    topo = {"linear": P.linear_topology, "rolling_count": P.rolling_count_topology}[topology]()
    full = P.refine(P.schedule(topo, cluster, r0=1.0, rate_epsilon=0.05).etg, cluster,
                    device="cpu")
    rec = TraceRecorder(name=f"golden-{topology}")
    burst = PS.StreamExecutor(full.etg, cluster,
                              PS.burst_trace(full.rate * 0.8, n_windows=100, jitter=4),
                              seed=11, recorder=rec).run()
    ramp = PS.StreamExecutor(full.etg, cluster,
                             PS.ramp_trace(0.3 * full.rate, 1.5 * full.rate, n_windows=120),
                             seed=3, recorder=rec).run()
    assert burst.fingerprint() == SHUFFLE_GOLDEN_FPS[(topology, "burst")]
    assert ramp.fingerprint() == SHUFFLE_GOLDEN_FPS[(topology, "ramp")]
    assert rec.records


def test_controlled_run_export_equals_reference(small):
    """The JSONL of the controlled run equals the reference's under the
    backend-name map; without the map only the backend names differ."""
    rec, ref_rec = TraceRecorder(name="run"), RO.TraceRecorder(name="run")
    res, ctl = _controlled_run(small, recorder=rec)
    ref_res, ref_ctl = _controlled_run(small, recorder=ref_rec, port=False)
    assert res.fingerprint() == ref_res.fingerprint()
    assert ctl.ledger.to_records() == ref_ctl.ledger.to_records()
    got, want = to_jsonl(rec, strip_wall=True), RO.to_jsonl(ref_rec, strip_wall=True)
    assert got != want  # devices, not backends, are named ...
    assert backend_map(got) == backend_map(want)  # ... and nothing else differs
    assert len(rec.dispatch_log) == len(ref_rec.dispatch_log)
    assert {d.backend for d in rec.dispatch_log} == {"cpu"}
    assert summary(rec).replace("cpu   ", "numpy ") == summary(ref_rec)


def test_jsonl_export_byte_identical_across_reruns(small):
    texts = []
    for _ in range(2):
        rec = TraceRecorder(name="rerun", wall_clock=True)
        _controlled_run(small, recorder=rec)
        texts.append(to_jsonl(rec, strip_wall=True))
    assert texts[0] == texts[1]
    assert any("wall_s" in json.loads(line) for line in to_jsonl(rec).splitlines())
    n, errors = validate_jsonl(texts[0])
    assert not errors and n > 10


def test_recorder_does_not_change_controlled_run(small):
    res_off, ctl_off = _controlled_run(small, recorder=None)
    res_null, _ = _controlled_run(small, recorder=NULL_RECORDER)
    res_on, ctl_on = _controlled_run(small, recorder=TraceRecorder(name="on"))
    assert res_on.fingerprint() == res_off.fingerprint() == res_null.fingerprint()
    assert ctl_on.log == ctl_off.log
    assert ctl_on.ledger == ctl_off.ledger


@pytest.mark.parametrize("budget", [None, 0.0], ids=["default", "zero budget"])
def test_ledger_records_match_reference(small, budget):
    kw = {} if budget is None else dict(elastic_budget=budget)
    res, ctl = _controlled_run(small, **kw)
    ref_res, ref_ctl = _controlled_run(small, port=False, **kw)
    assert res.fingerprint() == ref_res.fingerprint()
    assert ctl.ledger.to_records() == ref_ctl.ledger.to_records()
    assert ctl.log == ctl.ledger.legacy_view() == ref_ctl.log
    if budget == 0.0:
        assert int(res.migrations.sum()) == 0
        assert any(d.outcome == "budget" for d in ctl.ledger)
    else:
        assert ctl.ledger.accepted


def test_replan_decision_message_formats():
    d = ReplanDecision(window=7, trigger="hot", outcome="no_move")
    assert d.legacy_entry() == (7, "hot:no_move")
    d = ReplanDecision(window=3, trigger="saturated", outcome="skip", moves=2,
                       state_shipped=10.4, gain_rate=1.236)
    assert d.message == "saturated:skip gain=1.24/s moves=2 state=10"
    d = ReplanDecision(window=5, trigger="hot", outcome="deferred", moves=4)
    assert d.legacy_entry() == (5, "deferred:arbiter", 4.0)
    ledger = ReplanLedger([d])
    assert ledger.rejected == [d] and not ledger.accepted
    assert d.to_record()["budget"] == "inf"


@pytest.mark.parametrize("keyed", [False, True], ids=["shuffle", "keyed"])
def test_refine_recorder_export_equals_reference(small, keyed):
    """``refine(recorder=)``: the ``refine`` span, one ``refine.round`` span
    a round and every dispatch, as the reference records them."""
    ref_cluster, cluster, _ = small
    if keyed:
        ref_utg = R.keyed_rolling_count_topology(n_keys=16, zipf_s=1.5)
        ref_etg = R.schedule(ref_utg, ref_cluster, r0=1.0, rate_epsilon=0.05).etg
        probe = RS.StreamExecutor(ref_etg, ref_cluster,
                                  RS.TraceSpec(name="probe", n_windows=2, base_rate=1.0), seed=5)
        ref_skew = probe.skew_model_at(0)
    else:
        ref_utg = R.diamond_topology()
        ref_etg = R.schedule(ref_utg, ref_cluster, r0=1.0, rate_epsilon=0.05).etg
        ref_skew = None
    utg = convert.user_graph(ref_utg)
    etg = convert.execution_graph(ref_etg, utg)
    skew = None
    if keyed:
        skew = PS.StreamExecutor(etg, cluster, PS.TraceSpec(name="probe", n_windows=2,
                                                            base_rate=1.0), seed=5).skew_model_at(0)
    rec, ref_rec = TraceRecorder(name="refine"), RO.TraceRecorder(name="refine")
    got = P.refine(etg, cluster, skew=skew, recorder=rec, device="cpu")
    want = ref_refine(ref_etg, ref_cluster, skew=ref_skew, recorder=ref_rec, backend="numpy")
    assert got.moves == want.moves and got.throughput == want.throughput
    assert backend_map(to_jsonl(rec)) == backend_map(RO.to_jsonl(ref_rec))
    rounds = [r for r in rec.records if r["name"] == "refine.round"]
    assert len(rounds) == min(len(got.moves) + 1, 200)
    assert rec.records[0]["name"] == "refine" and rec.records[0]["args"]["backend"] == "cpu"
    if keyed:
        assert any(d.regime == "skew" for d in rec.dispatch_log)
    for d in rec.dispatch_log:
        assert d.site in ("max_stable_rate_batch", "score_task_machine_batch")
    # Without a recorder nothing is recorded and the result is the same.
    again = P.refine(etg, cluster, skew=skew, device="cpu")
    assert again.moves == got.moves and again.throughput == got.throughput


def test_executor_metrics_and_events(small):
    rec = TraceRecorder(name="metrics")
    res, _ = _controlled_run(small, recorder=rec)
    names = {m["name"]: m for m in rec.metrics.snapshot()}
    thpt = sum(names[f"executor.throughput.c{i}"]["value"] for i in range(4))
    assert thpt == pytest.approx(float(res.throughput.sum()) * res.window_s)
    assert names["executor.queue_max"]["hwm"] == pytest.approx(float(res.queue_max.max()))
    assert names["executor.replans_applied"]["value"] == int((res.migrations > 0).sum())
    assert names["controller.drift_checks"]["value"] > 0
    event_names = {r["name"] for r in rec.records if r["type"] == "event"}
    assert "run_start" in event_names and "drift" in event_names
    text = summary(rec)
    assert "refine.round" in text and "metrics:" in text


def test_metrics_registry_kinds():
    reg = MetricsRegistry()
    c = reg.counter("c")
    c.add(2.0)
    c.add()
    assert c.value == 3.0 and c.count == 2
    g = reg.gauge("g")
    g.set(5.0)
    g.set(2.0)
    assert g.value == 2.0 and g.hwm == 5.0
    h = reg.histogram("h", edges=(1.0, 10.0))
    for v in (0.5, 5.0, 50.0):
        h.record(v)
    assert h.counts == [1, 1, 1] and h.count == 3
    with pytest.raises(TypeError):
        reg.gauge("c")
    assert [m["name"] for m in reg.snapshot()] == ["c", "g", "h"]
    assert reg.snapshot() == _reference_registry().snapshot()


def _reference_registry():
    reg = RO.MetricsRegistry()
    reg.counter("c").add(2.0)
    reg.counter("c").add()
    reg.gauge("g").set(5.0)
    reg.gauge("g").set(2.0)
    h = reg.histogram("h", edges=(1.0, 10.0))
    for v in (0.5, 5.0, 50.0):
        h.record(v)
    return reg


def test_null_recorder_is_inert(small):
    _, cluster, full = small
    assert not NULL_RECORDER.enabled
    with NULL_RECORDER.span("x"):
        NULL_RECORDER.event("y")
    assert NULL_RECORDER.records == [] and len(NULL_RECORDER.metrics) == 0
    etg = convert.execution_graph(full.etg)
    ex = PS.StreamExecutor(etg, cluster, PS.burst_trace(full.rate * 0.8, n_windows=10, jitter=4),
                           seed=11)
    assert ex.recorder is NULL_RECORDER


def test_validate_accepts_good_and_rejects_malformed(tmp_path, small):
    rec = TraceRecorder(name="validate")
    _controlled_run(small, recorder=rec)
    jsonl, chrome = tmp_path / "trace.jsonl", tmp_path / "trace.json"
    to_jsonl(rec, path=jsonl)
    to_chrome_trace(rec, path=chrome)
    for path in (jsonl, chrome):
        n, errors = validate_file(path)
        assert not errors and n > 0
    bad = tmp_path / "bad.jsonl"
    bad.write_text(
        '{"type":"meta","name":"x","wall_clock":false,"records":2}\n'
        '{"type":"banana"}\n'
        '{"type":"event","name":"a","cat":"c","window":0}\n'
        '{"type":"event","name":"b","cat":"c","window":0,"ts":5}\n'
        '{"type":"event","name":"c","cat":"c","window":0,"ts":4}\n'
    )
    n, errors = validate_file(bad)
    assert len(errors) == 3
    bad_chrome = tmp_path / "bad.json"
    bad_chrome.write_text(json.dumps({"traceEvents": [
        {"name": "ok", "ph": "i", "s": "t", "ts": 1, "pid": 0, "tid": 0},
        {"name": "bad-ph", "ph": "Z", "ts": 2, "pid": 0, "tid": 0},
        {"name": "no-dur", "ph": "X", "ts": 3, "pid": 0, "tid": 0},
    ]}))
    n, errors = validate_file(bad_chrome)
    assert len(errors) == 2
    assert validate_main([str(jsonl), str(chrome)]) == 0
    assert validate_main([str(bad)]) == 1
    assert validate_main([]) == 2
    # The reference's validator reads the port's exports the same way.
    from repro.obs.validate import validate_file as ref_validate_file

    for path in (jsonl, chrome, bad, bad_chrome):
        assert validate_file(path) == ref_validate_file(path)


def test_chrome_trace_schema(small):
    rec, ref_rec = TraceRecorder(name="chrome"), RO.TraceRecorder(name="chrome")
    _controlled_run(small, recorder=rec)
    _controlled_run(small, recorder=ref_rec, port=False)
    trace = to_chrome_trace(rec)
    n, errors = validate_chrome(trace)
    assert not errors
    phases = {ev["ph"] for ev in trace["traceEvents"]}
    assert "X" in phases and "i" in phases and "M" in phases
    assert all(ev["dur"] >= 1 for ev in trace["traceEvents"] if ev["ph"] == "X")
    thread_names = {ev["args"]["name"] for ev in trace["traceEvents"]
                    if ev["ph"] == "M" and ev["name"] == "thread_name"}
    assert {"executor", "controller", "refine"} <= thread_names
    # The same events at the same ticks on the same threads as the
    # reference's (the metric snapshot carries the dispatch counters'
    # backend names, so it is left out).
    def timeline(tr):
        return [(e["name"], e["ph"], e["ts"], e["tid"]) for e in tr["traceEvents"]
                if e["ph"] != "M" and e["cat"] != "metrics"]

    ref_trace = RO.to_chrome_trace(ref_rec)
    assert timeline(trace) == timeline(ref_trace)


def test_multitenant_arbiter_surface():
    """Per-tenant grants, denials and budgets land on the runtime result
    and agree with the raw arbiter ledger; the shared recorder's export
    equals the reference's under the backend-name map."""
    import repro.multitenant as RMT
    import repro_torch.multitenant as PMT

    def run(C, MT, S, rec, sched_kw, run_kw):
        tenants = MT.TenantSet([
            MT.Tenant(name="alice", utg=C.linear_topology(), target_rate=6.0),
            MT.Tenant(name="bob", utg=C.diamond_topology(), target_rate=6.0),
        ])
        cluster = C.paper_cluster((2, 2, 2))
        ms = MT.schedule_tenants(list(tenants), cluster, **sched_kw)
        specs = [S.TraceSpec(name="alice", n_windows=24, base_rate=min(4.0, ms.rates[0])),
                 S.TraceSpec(name="bob", n_windows=24, base_rate=min(4.0, ms.rates[1]))]
        mtrace = MT.compile_tenant_traces(tenants, specs, cluster, seed=7)
        return MT.MultiTenantRuntime(ms, tenants, cluster, mtrace).run(
            online=True, moves_per_period=4, recorder=rec, **run_kw)

    rec, ref_rec = TraceRecorder(name="mt"), RO.TraceRecorder(name="mt")
    res = run(P, PMT, PS, rec, dict(device="cpu"), dict(device="cpu"))
    ref_res = run(R, RMT, RS, ref_rec, dict(backend="numpy"), {})
    assert tuple(ledger.name for ledger in res.arbiter) == res.names
    for ledger in res.arbiter:
        rows = [r for r in res.arbiter_log if r[0] == ledger.name]
        assert ledger.grants == sum(1 for r in rows if r[3])
        assert ledger.denials == sum(1 for r in rows if not r[3])
        assert ledger.moves_admitted == sum(r[2] for r in rows if r[3])
        assert ledger.moves_per_period == 4
        for _period, left in ledger.budget_remaining:
            assert 0 <= left <= 4
    assert res.arbiter_for("alice") is res.arbiter[0]
    span_names = {r["name"] for r in rec.records if r["type"] == "span"}
    assert {"tenant:alice", "tenant:bob"} <= span_names
    assert res.arbiter_log == ref_res.arbiter_log
    assert [a.__dict__ for a in res.arbiter] == [a.__dict__ for a in ref_res.arbiter]
    assert np.array_equal(res.satisfaction, ref_res.satisfaction)
    assert backend_map(to_jsonl(rec)) == backend_map(RO.to_jsonl(ref_rec))


def test_runtime_demo_prints_the_examples_sections(tmp_path, monkeypatch, capsys):
    """``python -m repro_torch.runtime_demo --device cpu`` prints what
    ``examples/runtime_demo.py`` prints — walls and backend names aside —
    and its exports validate."""
    import re

    from repro_torch import runtime_demo

    runtime_demo.main("cpu", str(tmp_path / "port"))
    port_text = capsys.readouterr().out
    spec = importlib.util.spec_from_file_location("runtime_demo_example",
                                                  ROOT / "examples" / "runtime_demo.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    (tmp_path / "ref").mkdir()
    monkeypatch.chdir(tmp_path / "ref")
    example.main()
    ref_text = capsys.readouterr().out

    def normal(text):
        text = re.sub(r"  wall=[0-9.]+s", "", text).replace("repro_torch.obs", "repro.obs")
        return re.sub(r"(-> |dispatch\.\w+\.)cpu(\s*)", lambda m: m[1] + "numpy" + m[2][2:],
                      text)

    assert normal(port_text) == normal(ref_text)
    assert "--- multi-tenant (shared cluster, weighted max-min) ---" in port_text
    for name in ("runtime_demo_trace.jsonl", "runtime_demo_trace.trace.json"):
        n, errors = validate_file(tmp_path / "port" / name)
        assert not errors and n > 0
        assert (tmp_path / "ref" / name).exists()

    def without_walls(path):
        recs = [json.loads(line) for line in path.read_text().splitlines()]
        return "".join(json.dumps({k: v for k, v in r.items() if k not in ("wall_s", "wall_dur_s")},
                                  sort_keys=True, separators=(",", ":")) + "\n" for r in recs)

    assert backend_map(without_walls(tmp_path / "port" / "runtime_demo_trace.jsonl")) == (
        backend_map(without_walls(tmp_path / "ref" / "runtime_demo_trace.jsonl")))
