"""Port parity: the batch policy evaluator and the policy-sweep kernel's
plain version.

``evaluate_policies_batch(device="cpu")`` runs ``kernels/policy_scan``'s
plain version, which must stay within 1e-9 (rtol and atol, the reference's
own contract) of ``repro``'s executor-per-pair backend (``_evaluate_numpy``)
and of its ``lax.scan`` (``_evaluate_jax``, reached through the scoped
``enable_x64`` alias), on shuffle and keyed traces and with external load;
the latency views agree too. The plain version sums in the executor's
order, so the state it carries is the executor's bit for bit: the admitted
rates, the throttle and the window-mean utilization are compared exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.runtime_stream as RS  # noqa: E402
from repro.runtime_stream.eval_jax import _evaluate_numpy  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.runtime_stream as PS  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.kernels.policy_scan import ops  # noqa: E402
from repro_torch.runtime_stream import convert as rconvert  # noqa: E402
from repro_torch.runtime_stream.eval_torch import scan_topology  # noqa: E402

FIELDS = ("throughput", "admitted", "dropped", "queue_total", "throttle", "machine_util_mean",
          "sustained")


@pytest.fixture(scope="module")
def cluster():
    return R.paper_cluster((1, 1, 1))


def _shuffle_setup(cluster):
    """The reference's parity setup (tests/test_runtime_stream.py) at P = 4."""
    topo = R.rolling_count_topology()
    etg = R.refine(R.schedule(topo, cluster, r0=1.0, rate_epsilon=0.05).etg, cluster).etg
    rstar, _ = R.max_stable_rate(etg, cluster)
    rr = R.round_robin_schedule(topo, cluster, etg.n_instances)
    rng = np.random.default_rng(0)
    policies = np.stack([etg.task_machine(), rr.task_machine(),
                         rng.integers(0, cluster.n_machines, etg.total_tasks),
                         np.zeros(etg.total_tasks, dtype=np.int64)])
    traces = [
        RS.ramp_trace(0.3 * rstar, 1.5 * rstar, n_windows=120).compile(cluster, seed=1),
        RS.burst_trace(0.6 * rstar, n_windows=120).compile(cluster, seed=2),
        RS.slowdown_trace(0.9 * rstar, machine=2, n_windows=120).compile(cluster, seed=3),
        RS.failure_trace(0.7 * rstar, machine=1, n_windows=120).compile(cluster, seed=4),
    ]
    return etg, traces, policies


def _keyed_setup(cluster):
    """The reference's keyed parity setup, one more placement."""
    utg = R.keyed_rolling_count_topology(n_keys=16, zipf_s=1.5)
    etg = R.schedule(utg, cluster, r0=1.0, rate_epsilon=0.05).etg
    probe = RS.StreamExecutor(etg, cluster, RS.TraceSpec(name="probe", n_windows=2,
                                                         base_rate=1.0), seed=5)
    r_skew, _ = R.max_stable_rate(etg, cluster, skew=probe.skew_model_at(0))
    r_even, _ = R.max_stable_rate(etg, cluster)
    rr = R.round_robin_schedule(utg, cluster, etg.n_instances)
    policies = np.stack([etg.task_machine(), rr.task_machine(),
                         etg.task_machine()[::-1].copy(), (etg.task_machine() + 1) % 3])
    traces = [
        RS.TraceSpec(name="flat", n_windows=120, base_rate=0.8 * r_skew).compile(
            cluster, seed=1, utg=utg),
        RS.skew_shift_trace(0.9 * r_skew, n_windows=120).compile(cluster, seed=2, utg=utg),
        RS.ramp_trace(0.3 * r_skew, 1.3 * r_even, n_windows=120).compile(cluster, seed=3,
                                                                         utg=utg),
    ]
    return etg, traces, policies


def _port(etg, cluster, traces):
    utg = convert.user_graph(etg.utg)
    return (convert.execution_graph(etg, utg), convert.cluster(cluster),
            [rconvert.compiled_trace(tr) for tr in traces])


def _external(cluster, traces):
    rng = np.random.default_rng(9)
    return rng.uniform(0.0, 0.3, size=traces[0].capacity.shape) * cluster.capacity


@pytest.mark.parametrize("setup", ["shuffle", "keyed", "shuffle, external load",
                                   "keyed, external load (m,)"])
def test_cpu_sweep_matches_reference_executor(cluster, setup):
    etg, traces, policies = (_keyed_setup if "keyed" in setup else _shuffle_setup)(cluster)
    ext = None
    if "external" in setup:
        ext = _external(cluster, traces)
        if "(m,)" in setup:
            ext = ext[0]
    cfg = RS.RuntimeConfig(max_queue=120.0) if "keyed" in setup else RS.RuntimeConfig()
    want_traces = traces
    if ext is not None:
        want_traces = [dataclasses.replace(tr, capacity=np.clip(tr.capacity - ext, 0.0, None))
                       for tr in traces]
    want = _evaluate_numpy(etg, cluster, want_traces, policies, cfg)
    p_etg, p_cluster, p_traces = _port(etg, cluster, traces)
    before = dict(ops.LAUNCHES)
    got = PS.evaluate_policies_batch(p_etg, p_cluster, p_traces, policies,
                                     config=PS.RuntimeConfig(**dataclasses.asdict(cfg)),
                                     device="cpu", external_load=ext)
    assert ops.LAUNCHES == before  # the CPU path launches nothing
    for field in FIELDS:
        x, y = getattr(got, field), getattr(want, field)
        assert x.shape == y.shape and x.dtype == np.float64, field
        np.testing.assert_allclose(x, y, rtol=1e-9, atol=1e-9, err_msg=field)
    # The carried state follows the executor's bits.
    for field in ("admitted", "throttle", "machine_util_mean"):
        assert np.array_equal(getattr(got, field), getattr(want, field)), field
    np.testing.assert_allclose(got.latency(), want.latency(), rtol=1e-9, atol=1e-9)
    for slo in (0.5, 2.0, 10.0):
        assert np.array_equal(got.latency_slo_frac(slo), want.latency_slo_frac(slo))
    assert got.window_s == want.window_s


@pytest.fixture
def x64_alias(monkeypatch):
    """Scoped alias ``jax.experimental.enable_x64 -> jax.enable_x64``: the
    reference's scan imports the former, which this JAX lacks. Undone
    after the test, so no other test in the worker sees it."""
    jax = pytest.importorskip("jax")
    import jax.experimental

    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)
    return jax


@pytest.mark.parametrize("setup", ["shuffle", "keyed"])
def test_cpu_sweep_matches_reference_scan(cluster, x64_alias, setup):
    from repro.runtime_stream.eval_jax import _evaluate_jax

    etg, traces, policies = (_keyed_setup if setup == "keyed" else _shuffle_setup)(cluster)
    want = _evaluate_jax(etg, cluster, traces, policies, RS.RuntimeConfig())
    got = PS.evaluate_policies_batch(*_port(etg, cluster, traces), policies, device="cpu")
    for field in FIELDS:
        np.testing.assert_allclose(getattr(got, field), getattr(want, field), rtol=1e-9,
                                   atol=1e-9, err_msg=field)
    np.testing.assert_allclose(got.latency(), want.latency(), rtol=1e-9, atol=1e-9)


def test_cpu_sweep_equals_port_executor_state():
    """Against the port's own executor, pair by pair: the throttle, the
    admitted rates and the utilization are equal; the totals differ only
    by NumPy's pairwise summation."""
    etg, traces, policies = _shuffle_setup(R.paper_cluster((2, 2, 2)))
    p_etg, p_cluster, p_traces = _port(etg, R.paper_cluster((2, 2, 2)), traces)
    res = PS.evaluate_policies_batch(p_etg, p_cluster, p_traces, policies, device="cpu")
    comp = p_etg.task_component()
    for b, tr in enumerate(p_traces):
        for p in range(policies.shape[0]):
            pe = P.ExecutionGraph(
                utg=p_etg.utg, n_instances=p_etg.n_instances.copy(),
                assignment=[policies[p][comp == c] for c in range(p_etg.utg.n_components)])
            run = PS.StreamExecutor(pe, p_cluster, tr).run()
            assert np.array_equal(res.admitted[b, p], run.admitted)
            assert np.array_equal(res.throttle[b, p], run.throttle)
            assert np.array_equal(res.machine_util_mean[b, p], run.machine_util.mean(axis=0))
            for field in ("throughput", "queue_total", "dropped"):
                np.testing.assert_allclose(getattr(res, field)[b, p], getattr(run, field),
                                           rtol=1e-13, atol=1e-12)


def test_validation_errors_match_reference(cluster):
    etg, traces, policies = _shuffle_setup(cluster)
    p_etg, p_cluster, p_traces = _port(etg, cluster, traces)
    bad_idx = policies.copy()
    bad_idx[0, 0] = -1
    odd = RS.TraceSpec(name="odd", n_windows=7, base_rate=1.0).compile(cluster)
    keyed = R.keyed_rolling_count_topology()
    keyed_etg = R.schedule(keyed, cluster, r0=1.0, rate_epsilon=0.5).etg
    cases = [
        (etg, traces, policies[:, :-1], None),
        (etg, traces, bad_idx, None),
        (etg, [], policies, None),
        (etg, traces[:2] + [odd], policies, None),
        (etg, traces, policies, np.ones(2)),
        (keyed_etg, traces, keyed_etg.task_machine()[None, :], None),
    ]
    for c_etg, c_traces, c_pol, ext in cases:
        with pytest.raises(ValueError) as want:
            RS.evaluate_policies_batch(c_etg, cluster, c_traces, c_pol, backend="numpy",
                                       external_load=ext)
        pe, pc, pt = _port(c_etg, cluster, c_traces)
        with pytest.raises(ValueError) as got:
            PS.evaluate_policies_batch(pe, pc, pt, c_pol, device="cpu", external_load=ext)
        assert str(got.value) == str(want.value)


# --- The plain version itself --------------------------------------------


def _scan_inputs(seed, B, P, W, topo_name="diamond", m=5):
    """Random ``policy_scan`` operands on a small topology."""
    rng = np.random.default_rng(seed)
    ref_cluster = R.paper_cluster((2, 2, 1))
    utg = getattr(R, f"{topo_name}_topology")()
    etg = R.schedule(utg, ref_cluster, r0=1.0, rate_epsilon=0.5).etg
    p_etg = convert.execution_graph(etg)
    T = etg.total_tasks
    tm = rng.integers(0, m, size=(P, T))
    e = rng.uniform(0.5, 2.0, size=(P, T))
    met = rng.uniform(0.0, 0.3, size=(P, T))
    rates = rng.uniform(0.5, 4.0, size=(B, W))
    caps = rng.uniform(2.0, 6.0, size=(B, W, m))
    caps[:, W // 2:, 0] = 0.0  # machine 0 dies half way
    t = torch.from_numpy
    return (t(rates), t(caps), t(tm.astype(np.int32)), t(e), t(met),
            torch.zeros((B, W, 0), dtype=torch.float64)), scan_topology(p_etg)


def test_ids_outside_machines_serve_nowhere():
    """A task on an id outside [0, m) behaves as on an extra machine with no
    capacity: the same metrics, bit for bit."""
    (rates, caps, tm, e, met, shares), topo = _scan_inputs(3, 2, 3, 40)
    m = caps.shape[2]
    tm_out = tm.clone()
    tm_out[:, ::3] = m
    cfg = ops.ScanConfig(max_queue=50.0)
    got = ops.policy_scan(rates, caps, tm_out, e, met, shares, topo, cfg)
    extra = torch.cat([caps, torch.zeros_like(caps[:, :, :1])], dim=2).contiguous()
    want = ops.policy_scan(rates, extra, tm_out, e, met, shares, topo, cfg)
    for g, w in zip(got[:5], want[:5]):
        assert torch.equal(g, w)
    assert torch.equal(got.machine_util_mean, want.machine_util_mean[:, :, :m])


def test_wrapper_checks_operands_and_width():
    (rates, caps, tm, e, met, shares), topo = _scan_inputs(4, 2, 2, 8)
    cfg = ops.ScanConfig()
    with pytest.raises(TypeError):
        ops.policy_scan(rates, caps, tm.long(), e, met, shares, topo, cfg)
    with pytest.raises(ValueError):
        ops.policy_scan(rates, caps, tm, e[:, :-1].contiguous(), met, shares, topo, cfg)
    with pytest.raises(ValueError):
        ops.policy_scan(rates, caps, tm, e, met, shares[:, :-1], topo, cfg)
    with pytest.raises(ValueError, match="tasks"):
        ops.policy_scan(rates, caps, tm, e, met, shares,
                        dataclasses.replace(topo, offsets=topo.offsets[:-1] + (99,)), cfg)
    with pytest.raises(ValueError):
        ops.ScanTopology(offsets=(0, 2), alpha=(1.0,), sources=(True,), parents=((3,),))
    # The paper's large scenario fits one block; past one pair's shared
    # memory the kernel keeps a pair's state in a global scratch, and the
    # plain sweep runs a width that used to be refused (no capacity: nothing
    # serves).
    assert ops.smem_bytes(478, 180, 4, 0) < ops.SMEM_LIMIT
    assert ops.smem_bytes(537, 180, 4, 1) < ops.SMEM_LIMIT
    assert ops.smem_bytes(6400, 180, 4, 0) > ops.SMEM_LIMIT
    assert not ops.state_in_global(478, 180, 4, 0) and ops.state_in_global(6400, 180, 4, 0)
    wide = torch.zeros((1, 8, 10_000), dtype=torch.float64)
    out = ops.policy_scan(rates[:1], wide, tm, e, met, shares[:1], topo, cfg)
    assert out.throughput.shape == (1, 2, 8) and out.machine_util_mean.shape == (1, 2, 10_000)
    assert not out.throughput.any() and bool(out.dropped.ge(0.0).all())
    # Empty sweeps return empty results.
    out = ops.policy_scan(rates, caps, tm[:0], e[:0], met[:0], shares, topo, cfg)
    assert out.throughput.shape == (2, 0, 8) and out.machine_util_mean.shape == (2, 0, 5)


@pytest.mark.parametrize("n_instances, types", [
    ((2, 1666, 1666, 1666), (20, 70, 90)),     # 5 000 tasks on 180 machines
    ((2, 12, 13, 13), (800, 3200, 4000)),      # 40 tasks on 8 000 machines
])
def test_cpu_sweep_past_one_blocks_state_matches_reference(n_instances, types):
    """Sweeps whose (trace, placement) state does not fit one block (the
    kernel's global-state instance on a card): the plain version against
    the reference's executor per pair, within 1e-9, over a few windows."""
    cluster = R.paper_cluster(types)
    utg = R.linear_topology()
    etg = R.round_robin_schedule(utg, cluster, np.asarray(n_instances))
    T, m = etg.total_tasks, cluster.n_machines
    assert ops.state_in_global(T, m, 4, 0, 3)
    rng = np.random.default_rng(T)
    moved = etg.task_machine().copy()
    moved[rng.integers(0, T, 3)] = rng.integers(0, m, 3)
    policies = np.stack([etg.task_machine(), moved, rng.integers(0, m, T)])
    rate, _ = R.max_stable_rate(etg, cluster)
    traces = [RS.ramp_trace(0.5 * rate, 1.6 * rate, n_windows=5).compile(cluster, seed=1),
              RS.failure_trace(0.9 * rate, machine=1, n_windows=5).compile(cluster, seed=2)]
    cfg = RS.RuntimeConfig(max_queue=40.0)
    want = RS.evaluate_policies_batch(etg, cluster, traces, policies, config=cfg,
                                      backend="numpy")
    p_etg, p_cluster, p_traces = _port(etg, cluster, traces)
    got = PS.evaluate_policies_batch(p_etg, p_cluster, p_traces, policies,
                                     config=PS.RuntimeConfig(**dataclasses.asdict(cfg)),
                                     device="cpu")
    for field in FIELDS:
        x, y = getattr(got, field), getattr(want, field)
        assert x.shape == y.shape, field
        np.testing.assert_allclose(x, y, rtol=1e-9, atol=1e-9, err_msg=field)
    assert float(want.dropped.max()) > 0.0  # the queues fill


def test_cpu_sweep_on_mostly_empty_machines_matches_reference():
    """Placements that leave almost every machine empty (the global-state
    instance's occupied machines on a card): 92 tasks on 8 000 machines, one
    placement on 3 of them, one on 1; the plain version against the
    reference's executor per pair, within 1e-9, utilization 0.0 exactly on
    the empty machines."""
    cluster = R.paper_cluster((800, 3200, 4000))
    etg = R.round_robin_schedule(R.linear_topology(), cluster, np.asarray((2, 30, 30, 30)))
    T, m = etg.total_tasks, cluster.n_machines
    assert ops.state_in_global(T, m, 4, 0, 3)
    rng = np.random.default_rng(92)
    policies = np.stack([etg.task_machine(), rng.choice([7, 4000, m - 1], T), np.full(T, 5)])
    rate, _ = R.max_stable_rate(etg, cluster)
    traces = [RS.ramp_trace(0.5 * rate, 1.6 * rate, n_windows=5).compile(cluster, seed=1),
              RS.failure_trace(0.9 * rate, machine=5, n_windows=5).compile(cluster, seed=2)]
    cfg = RS.RuntimeConfig(max_queue=40.0)
    want = RS.evaluate_policies_batch(etg, cluster, traces, policies, config=cfg,
                                      backend="numpy")
    p_etg, p_cluster, p_traces = _port(etg, cluster, traces)
    got = PS.evaluate_policies_batch(p_etg, p_cluster, p_traces, policies,
                                     config=PS.RuntimeConfig(**dataclasses.asdict(cfg)),
                                     device="cpu")
    for field in FIELDS:
        x, y = getattr(got, field), getattr(want, field)
        assert x.shape == y.shape, field
        np.testing.assert_allclose(x, y, rtol=1e-9, atol=1e-9, err_msg=field)
    empty = np.ones((len(policies), m), dtype=bool)
    for p, placement in enumerate(policies):
        empty[p, placement] = False
    util = got.machine_util_mean
    assert (util[:, empty] == 0.0).all() and (util[:, ~empty] > 0.0).any()
    assert float(want.dropped.max()) > 0.0  # the queues fill


def test_runtime_setup_constants_give_the_sweep_and_traces():
    """``profile_runtime``'s sweep: N_POLICIES seeded placements, the first
    the given one and each other one task moved; the six drift scenarios
    over N_WINDOWS windows."""
    from repro_torch.launch import profile_runtime as PR

    small = P.paper_cluster((2, 2, 2))
    etg = P.schedule(P.linear_topology(), small, r0=1.0, rate_epsilon=1.0).etg
    base = etg.task_machine()
    pol = PR.sweep_policies(etg, small.n_machines)
    assert pol.shape == (PR.N_POLICIES, base.size)
    assert np.array_equal(pol[0], base)
    assert ((pol[1:] != base).sum(axis=1) <= 1).all()
    assert pol.min() >= 0 and pol.max() < small.n_machines
    assert np.array_equal(pol, PR.sweep_policies(etg, small.n_machines))
    specs = PR.runtime_traces(small, 10.0)
    assert tuple(specs) == PR.SCENARIOS
    for spec in specs.values():
        tr = spec.compile(small, seed=0, utg=etg.utg)
        assert tr.rates.shape == (PR.N_WINDOWS,)
        assert tr.capacity.shape == (PR.N_WINDOWS, small.n_machines)
