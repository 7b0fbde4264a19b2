"""Port parity: multi-tenant scheduling (``repro_torch.multitenant``).

Every scenario runs through both packages, the reference with
``backend="numpy"`` (its ``"auto"`` may take JAX paths that lack x64,
ROADMAP C-ref-1) and the port with ``device="cpu"`` (the scorer's plain
version; the card's kernels equal it bit for bit,
``tests/test_torch_multitenant_cuda.py``). Allocations — rates, rounds,
candidate counts, logs and placements — must be identical;
``TenantBatchScorer`` scores must equal the reference's (1e-12 with an
identical mask and argmax on a network-modelled cluster, ROADMAP
C-port-1). The property tests are derandomized, so they cannot flip with
the seed as the reference's do (C-ref-3).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.multitenant as RMT  # noqa: E402
import repro.runtime_stream as RS  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.multitenant as PMT  # noqa: E402
import repro_torch.runtime_stream as PS  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core.schedule_state import ScheduleState  # noqa: E402

REF_KW = dict(backend="numpy")
PORT_KW = dict(device="cpu")

# The reference's frozen three-tenant golden
# (tests/test_multitenant_golden.py::GOLDEN).
GOLDEN = {
    "alice": (3.317152100242718, [0, 0, 2, 1, 1, 1, 2, 1, 0, 4, 5, 3]),
    "bob": (2.634569447432816, [2, 0, 4, 5, 0, 0, 1, 1, 4, 5, 3, 2]),
    "carol": (0.869261695212773, [1, 2, 0, 2, 0, 4, 3, 3, 3, 3, 2, 4, 5, 4, 1, 5]),
}


def port_tenant(t):
    """The port's ``Tenant`` for the reference's ``t`` (no skew model)."""
    assert t.skew is None
    return PMT.Tenant(name=t.name, utg=convert.user_graph(t.utg), target_rate=t.target_rate,
                      priority=t.priority)


def _three(M):
    return [
        M.Tenant(name="alice", utg=(R if M is RMT else P).linear_topology(), target_rate=10.0,
                 priority=2.0),
        M.Tenant(name="bob", utg=(R if M is RMT else P).diamond_topology(), target_rate=30.0),
        M.Tenant(name="carol", utg=(R if M is RMT else P).star_topology(), target_rate=10.0),
    ]


def assert_same_schedule(got, want):
    """Two ``MultiTenantSchedule``s (port, reference) are identical."""
    assert got.rounds == want.rounds
    assert got.candidates_evaluated == want.candidates_evaluated
    assert got.log == want.log
    assert np.array_equal(got.rates, want.rates)
    for a, b in zip(got.allocations, want.allocations):
        assert a.name == b.name and a.rate == b.rate
        assert a.target_rate == b.target_rate and a.priority == b.priority
        assert a.etg.n_instances.tolist() == b.etg.n_instances.tolist()
        assert a.etg.task_machine().tolist() == b.etg.task_machine().tolist()


def _both(tenants_ref, ref_cluster, **kw):
    """``schedule_tenants`` of one fleet through both packages."""
    want = RMT.schedule_tenants(tenants_ref, ref_cluster, **REF_KW, **kw)
    got = PMT.schedule_tenants([port_tenant(t) for t in tenants_ref],
                               convert.cluster(ref_cluster), **PORT_KW, **kw)
    return got, want


@pytest.mark.parametrize("package", ["multitenant", "obs"])
def test_public_names_match_reference(package):
    import importlib

    port = importlib.import_module(f"repro_torch.{package}")
    ref = importlib.import_module(f"repro.{package}")
    assert port.__all__ == ref.__all__
    assert len(port.__all__) == {"multitenant": 14, "obs": 15}[package]
    assert all(hasattr(port, name) for name in port.__all__)


def test_three_tenant_golden():
    got, want = _both(_three(RMT), R.paper_cluster((2, 2, 2)))
    assert_same_schedule(got, want)
    assert got.rounds == 10 and got.candidates_evaluated == 43
    for name, (rate, placement) in GOLDEN.items():
        alloc = got.allocation(name)
        assert alloc.rate == pytest.approx(rate, rel=1e-12), name
        assert alloc.etg.task_machine().tolist() == placement, name


def test_fair_shares_and_floors_match_reference():
    ref_tenants = _three(RMT)
    tenants = [port_tenant(t) for t in ref_tenants]
    assert np.array_equal(PMT.fair_shares(tenants), RMT.fair_shares(ref_tenants))
    cl = R.paper_cluster((2, 2, 2))
    assert np.array_equal(
        PMT.fair_slice_floors(tenants, convert.cluster(cl), warm_refine_rounds=8, **PORT_KW),
        RMT.fair_slice_floors(ref_tenants, cl, warm_refine_rounds=8, **REF_KW))


# ------------------------------------------------------------ batch scoring


def _skewed_tenant(C, MT, S, name, cluster, seed=11):
    """The reference golden's keyed tenant, built from either package."""
    utg = C.keyed_rolling_count_topology()
    reals = (S.TraceSpec(name="probe", n_windows=4, base_rate=1.0)
             .compile(cluster, seed=seed, utg=utg).realizations_at(0))
    skew = C.SkewModel(utg, {e: r.shares for e, r in reals.items()})
    return MT.Tenant(name=name, utg=utg, target_rate=8.0, skew=skew)


def _resource_cluster():
    """paper_cluster((2, 2, 2)) with memory (0.5/1/1.5/2 units an
    instance, 6 a machine) and two racks (reference objects)."""
    base = R.paper_cluster((2, 2, 2))
    m = base.n_machines
    return R.Cluster(machine_types=base.machine_types, capacity=base.capacity,
                     profile=base.profile.with_mem(np.array([0.5, 1.0, 1.5, 2.0])),
                     mem_capacity=np.full(m, 6.0),
                     distance=R.rack_distance_matrix(np.arange(m) % 2), net_penalty=0.05)


def _states(kind):
    """(reference MultiTenantState, port MultiTenantState) of one scoring
    case, the port's built from the reference's allocation."""
    if kind == "resources":
        ref_cluster = _resource_cluster()
        ref_tenants = _three(RMT)
        ref = RMT.MultiTenantState.first_assignment(RMT.TenantSet(ref_tenants), ref_cluster)
        ref.rates = np.array([0.6 * ref.residual_rstar(t) for t in range(3)])
        rates = ref.rates
        etgs = [st.to_etg() for st in ref.states]
    else:
        ref_cluster = R.paper_cluster((2, 2, 2))
        ref_tenants = (
            [RMT.Tenant(name="alice", utg=R.linear_topology(), target_rate=10.0),
             _skewed_tenant(R, RMT, RS, "kira", ref_cluster)] if kind == "keyed"
            else _three(RMT))
        ms = RMT.schedule_tenants(ref_tenants, ref_cluster, **REF_KW)
        rates = ms.rates * 0.9
        etgs = [a.etg for a in ms.allocations]
        ref = RMT.MultiTenantState(
            RMT.TenantSet(ref_tenants), ref_cluster,
            [R.ScheduleState.from_etg(e, ref_cluster, skew=t.skew)
             for e, t in zip(etgs, ref_tenants)], rates=rates)
    cluster = convert.cluster(ref_cluster)
    tenants = [port_tenant(t) if t.skew is None
               else _skewed_tenant(P, PMT, PS, t.name, cluster) for t in ref_tenants]
    port = PMT.MultiTenantState(
        PMT.TenantSet(tenants), cluster,
        [ScheduleState.from_etg(convert.execution_graph(e, t.utg), cluster, skew=t.skew)
         for e, t in zip(etgs, tenants)], rates=rates)
    return ref, port


def _sweeps(mt, cap_rows=36):
    """Per tenant, a count-preserving relocation sweep (each task to each
    other machine, the first ``cap_rows`` rows), with an empty sweep
    between the first two."""
    m = mt.cluster.n_machines
    sweeps = []
    for t, st in enumerate(mt.states):
        base = st.task_machine()
        rows = []
        for col in range(base.shape[0]):
            for dest in range(m):
                if dest != base[col]:
                    row = base.copy()
                    row[col] = dest
                    rows.append(row)
        sweeps.append((t, np.stack(rows[:cap_rows])))
    sweeps.insert(1, (1, np.zeros((0, mt.states[1].task_machine().size), np.int64)))
    return sweeps


@pytest.mark.parametrize("kind", ["plain", "keyed", "resources"])
def test_batched_scores_match_reference(kind):
    """The port's tenant-batched scores equal the reference's ``score``
    (bit for bit; 1e-12 with the network term, C-port-1) and agree with
    both packages' per-tenant residual loop ``reference_scores`` at 1e-12
    with identical mask and argmax."""
    ref_mt, mt = _states(kind)
    sweeps = _sweeps(ref_mt)
    ref_scorer = RMT.TenantBatchScorer(ref_mt, **REF_KW)
    scorer = PMT.TenantBatchScorer(mt, **PORT_KW)
    got, want = scorer.score(sweeps), ref_scorer.score(sweeps)
    assert scorer.candidates_evaluated == ref_scorer.candidates_evaluated == sum(
        r.shape[0] for _, r in sweeps)
    assert scorer.t_max == ref_scorer.t_max and scorer.pad_comp == ref_scorer.pad_comp
    assert np.array_equal(scorer._resid_cap, ref_scorer._resid_cap)
    any_feasible = any_infeasible = False
    for (t, rows), (rates, thpt), (ref_rates, ref_thpt) in zip(sweeps, got, want):
        if kind == "resources":
            np.testing.assert_allclose(rates, ref_rates, rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(thpt, ref_thpt, rtol=1e-12, atol=1e-12)
        else:
            assert np.array_equal(rates, ref_rates) and np.array_equal(thpt, ref_thpt)
        assert np.array_equal(rates > 0.0, ref_rates > 0.0)
        if rows.shape[0] == 0:
            assert rates.shape == thpt.shape == (0,)
            continue
        assert int(np.argmax(rates)) == int(np.argmax(ref_rates))
        loop_rates, loop_thpt = scorer.reference_scores(t, rows)
        ref_loop, _ = ref_scorer.reference_scores(t, rows)
        np.testing.assert_allclose(rates, loop_rates, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(thpt, loop_thpt, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(loop_rates, ref_loop, rtol=1e-12, atol=1e-12)
        assert int(np.argmax(rates)) == int(np.argmax(loop_rates))
        any_feasible |= bool(np.any(rates > 0.0))
        any_infeasible |= bool(np.any(rates == 0.0))
    assert any_feasible
    if kind == "resources":
        assert any_infeasible  # the residual cliff: rows over memory or fixed load


def test_empty_and_zero_row_sweeps():
    ref_mt, mt = _states("plain")
    scorer = PMT.TenantBatchScorer(mt, **PORT_KW)
    width = mt.states[0].task_machine().shape[0]
    out = scorer.score([(0, np.zeros((0, width), dtype=np.int64))])
    assert out[0][0].shape == (0,) and out[0][1].shape == (0,)
    assert scorer.score([]) == []
    assert scorer.candidates_evaluated == 0
    with pytest.raises(ValueError, match="sweep must be"):
        scorer.score([(0, np.zeros((2, width + 1), dtype=np.int64))])


def test_residual_rates_match_reference():
    ref_mt, mt = _states("plain")
    got = PMT.TenantBatchScorer(mt, **PORT_KW).residual_rates()
    assert np.array_equal(got, RMT.TenantBatchScorer(ref_mt, **REF_KW).residual_rates())
    for t in range(len(mt.states)):
        assert mt.residual_rstar(t) == ref_mt.residual_rstar(t)
        np.testing.assert_allclose(got[t], mt.residual_rstar(t), rtol=1e-9, atol=1e-12)
        assert np.array_equal(mt.residual_capacity(t), ref_mt.residual_capacity(t))


# ------------------------------------------------------------ allocation


def test_solo_identity_with_schedule_and_refine():
    cl = P.paper_cluster((2, 2, 2))
    utg = P.rolling_count_topology()
    ms = PMT.schedule_tenants([PMT.Tenant(name="only", utg=utg, target_rate=5.0)], cl,
                              **PORT_KW)
    ref = P.refine(P.schedule(utg, cl, r0=1.0, rate_epsilon=0.5).etg, cl, **PORT_KW)
    alloc = ms.allocations[0]
    assert alloc.rate == ref.rate
    assert alloc.etg.task_machine().tolist() == ref.etg.task_machine().tolist()
    assert ms.rounds == 0 and ms.candidates_evaluated == 0
    got, want = _both([RMT.Tenant(name="only", utg=R.rolling_count_topology(),
                                  target_rate=5.0)], R.paper_cluster((2, 2, 2)))
    assert_same_schedule(got, want)


def test_determinism_and_submission_order_invariance():
    ref_cluster = R.paper_cluster((2, 1, 1))
    cluster = convert.cluster(ref_cluster)
    tenants = [port_tenant(t) for t in _three(RMT)]
    a = PMT.schedule_tenants(tenants, cluster, **PORT_KW)
    b = PMT.schedule_tenants(tenants, cluster, **PORT_KW)
    c = PMT.schedule_tenants(list(reversed(tenants)), cluster, **PORT_KW)
    for t in tenants:
        x, y, z = a.allocation(t.name), b.allocation(t.name), c.allocation(t.name)
        assert x.rate == y.rate == z.rate
        assert (x.etg.task_machine().tolist() == y.etg.task_machine().tolist()
                == z.etg.task_machine().tolist())
    assert_same_schedule(a, RMT.schedule_tenants(_three(RMT), ref_cluster, **REF_KW))
    assert_same_schedule(c, RMT.schedule_tenants(list(reversed(_three(RMT))), ref_cluster,
                                                 **REF_KW))


def test_thin_slice_tenants_defer_and_still_get_served():
    ref_tenants = [
        RMT.Tenant(name="whale", utg=R.diamond_topology(), target_rate=50.0, priority=500.0)
    ] + [RMT.Tenant(name=f"shrimp{i}", utg=R.linear_topology(), target_rate=5.0)
         for i in range(4)]
    got, want = _both(ref_tenants, R.paper_cluster((2, 2, 2)), validate=True)
    assert_same_schedule(got, want)
    assert PMT.fair_shares([port_tenant(t) for t in ref_tenants])[0] > 0.99
    assert got.allocation("whale").rate > 0.0
    assert sum(got.allocation(f"shrimp{i}").rate for i in range(4)) > 0.0


def test_met_oversubscribed_fleet_raises():
    tenants = [PMT.Tenant(name=f"t{i:02d}", utg=P.star_topology(), target_rate=5.0)
               for i in range(40)]
    cl = P.paper_cluster((1, 1, 1))
    tiny = cl.with_capacity(np.full(cl.n_machines, 6.0))
    with pytest.raises(ValueError, match="MET load alone"):
        PMT.schedule_tenants(tenants, tiny, **PORT_KW)


def test_tenant_validation_matches_reference():
    def error(fn):
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 - the message is what is compared
            return type(exc).__name__, str(exc)
        return None

    cases = [
        lambda M, C: M.Tenant(name="", utg=C.linear_topology(), target_rate=1.0),
        lambda M, C: M.Tenant(name="a", utg=C.linear_topology(), target_rate=0.0),
        lambda M, C: M.Tenant(name="a", utg=C.linear_topology(), target_rate=1.0, priority=0.0),
        lambda M, C: M.TenantSet([]),
        lambda M, C: M.TenantSet([M.Tenant(name="a", utg=C.linear_topology(), target_rate=1.0),
                                  M.Tenant(name="a", utg=C.star_topology(), target_rate=1.0)]),
    ]
    for case in cases:
        got = error(lambda: case(PMT, P))
        assert got is not None and got == error(lambda: case(RMT, R))


# ------------------------------------------------------------ runtime


def test_runtime_matches_reference():
    """Satisfaction, the arbiter's log and roll-ups, every tenant's
    fingerprint and the planned loads equal the reference's."""
    def run(C, MT, S, sched_kw, run_kw):
        tenants = MT.TenantSet([
            MT.Tenant(name="alice", utg=C.linear_topology(), target_rate=6.0),
            MT.Tenant(name="bob", utg=C.diamond_topology(), target_rate=6.0, priority=2.0),
            MT.Tenant(name="carol", utg=C.star_topology(), target_rate=4.0),
        ])
        cluster = C.paper_cluster((2, 2, 2))
        ms = MT.schedule_tenants(list(tenants), cluster, **sched_kw)
        specs = [S.TraceSpec(name=t.name, n_windows=60, base_rate=0.5 * ms.rates[i],
                             events=(S.rate_ramp(1.2 * ms.rates[i], start=10, end=40),))
                 for i, t in enumerate(tenants)]
        capacity = S.TraceSpec(name="capacity", n_windows=60, base_rate=1.0,
                               events=(S.machine_slowdown(5, 0.5, start=45),))
        mtrace = MT.compile_tenant_traces(tenants, specs, cluster, seed=3,
                                          capacity_spec=capacity)
        rt = MT.MultiTenantRuntime(ms, tenants, cluster, mtrace)
        return rt.planned_loads(), rt.run(online=True, moves_per_period=4, **run_kw)

    loads, res = run(P, PMT, PS, PORT_KW, PORT_KW)
    ref_loads, ref_res = run(R, RMT, RS, REF_KW, {})
    assert np.array_equal(loads, ref_loads)
    assert res.names == ref_res.names
    assert np.array_equal(res.satisfaction, ref_res.satisfaction)
    assert res.arbiter_log == ref_res.arbiter_log and res.arbiter_log
    assert [a.__dict__ for a in res.arbiter] == [a.__dict__ for a in ref_res.arbiter]
    for r, w in zip(res.results, ref_res.results):
        assert r.fingerprint() == w.fingerprint() and r.events == w.events


def test_runtime_rejects_per_tenant_capacity_events():
    tenants = PMT.TenantSet([PMT.Tenant(name="a", utg=P.linear_topology(), target_rate=4.0)])
    cluster = P.paper_cluster((1, 1, 1))
    spec = PS.TraceSpec(name="a", n_windows=12, base_rate=2.0,
                        events=(PS.machine_slowdown(0, 0.5, start=4),))
    with pytest.raises(ValueError, match="capacity events"):
        PMT.compile_tenant_traces(tenants, [spec], cluster)
    with pytest.raises(ValueError, match="one TraceSpec per tenant"):
        PMT.compile_tenant_traces(tenants, [], cluster)


# ------------------------------------------------------------ properties

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from multitenant_strategies import random_tenant_fleet, roomy_cluster  # noqa: E402

# Derandomized: the same examples on every run, so these cannot flip with
# the seed (ROADMAP C-ref-3).
SETTINGS = settings(max_examples=16, deadline=None, derandomize=True, database=None,
                    suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
FAST = dict(warm_refine_rounds=8, structure_attempts=1, refine_moves=1)


@SETTINGS
@given(fleet=random_tenant_fleet(min_tenants=1, max_tenants=5), data=st.data())
def test_random_fleets_match_reference(fleet, data):
    """Random fleets (mixed shuffle/keyed DAGs, skewed priorities,
    heterogeneous machine mixes): the port's allocation is the
    reference's, and permuting submission order changes nothing."""
    ref_cluster = data.draw(roomy_cluster(max_per_type=2))
    ref_tenants = list(fleet)
    got, want = _both(ref_tenants, ref_cluster, validate=True, **FAST)
    assert_same_schedule(got, want)
    perm = data.draw(st.permutations(list(range(len(ref_tenants)))))
    shuffled = PMT.schedule_tenants([port_tenant(ref_tenants[i]) for i in perm],
                                    convert.cluster(ref_cluster), **PORT_KW, **FAST)
    for a in got.allocations:
        b = shuffled.allocation(a.name)
        assert a.rate == b.rate
        assert a.etg.task_machine().tolist() == b.etg.task_machine().tolist()


@SETTINGS
@given(fleet=random_tenant_fleet(min_tenants=2, max_tenants=4), data=st.data())
def test_solo_no_regression_vs_fair_slice(fleet, data):
    """Every tenant gets at least its fair-slice floor (the warm-start
    guarantee), recomputed independently by ``fair_slice_floors``."""
    ref_cluster = data.draw(roomy_cluster(max_per_type=2))
    cluster = convert.cluster(ref_cluster)
    tenants = [port_tenant(t) for t in fleet]
    ms = PMT.schedule_tenants(tenants, cluster, **PORT_KW, **FAST)
    floors = PMT.fair_slice_floors(tenants, cluster, warm_refine_rounds=FAST[
        "warm_refine_rounds"], **PORT_KW)
    assert np.all(ms.rates >= floors * (1.0 - 1e-6))
    states = [ScheduleState.from_etg(a.etg, cluster, skew=t.skew)
              for a, t in zip(ms.allocations, tenants)]
    assert PMT.MultiTenantState(PMT.TenantSet(tenants), cluster, states,
                                rates=ms.rates).feasible(slack=1e-9)
