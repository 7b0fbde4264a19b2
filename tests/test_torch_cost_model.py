"""Port parity: ``repro_torch.core.cost_model`` against ``repro.core.cost_model``.

The NumPy closed form is the bit-exact oracle. The contract is
``_assert_parity`` of tests/test_sched_scoring_kernels.py (<= 1e-12
rel/abs, identical feasibility mask, identical argmax); on the port's CPU
path the scorer's rates are in fact bit-identical, which is asserted too.
The network term contracts distances in machine order where the reference
uses a BLAS product, so it is held to 1e-12 only.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core import cost_model as rcm  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import cost_model as pcm  # noqa: E402


def _assert_parity(got, ref, exact=True):
    r_ref, t_ref = ref
    r_got, t_got = got
    np.testing.assert_allclose(r_got, r_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(t_got, t_ref, rtol=1e-12, atol=1e-12)
    assert np.array_equal(r_got == 0.0, r_ref == 0.0)
    if r_ref.size:
        assert int(np.argmax(t_got)) == int(np.argmax(t_ref))
    if exact:
        assert np.array_equal(r_got, r_ref)
        assert np.array_equal(t_got, t_ref)


def _problem(seed, B, T, m, n, per_row=False, infeasible_rows=0):
    rng = np.random.default_rng(seed)
    tm = rng.integers(0, m, size=(B, T))
    comp = np.sort(rng.integers(0, n, size=T))
    unit_ir = rng.uniform(0.05, 1.5, size=(B, T) if per_row else T)
    if per_row:
        comp = np.sort(rng.integers(0, n, size=(B, T)), axis=1)
    e_cm = rng.uniform(0.3, 3.0, size=(n, m))
    met_cm = rng.uniform(0.0, 0.4, size=(n, m))
    cap = rng.uniform(2.0, 12.0, size=m)
    if infeasible_rows and B:
        hot = rng.integers(0, B, size=infeasible_rows)
        tm[hot, :] = 0
        met_cm[:, 0] = cap[0]
    return rng, tm, comp, unit_ir, e_cm, met_cm, cap


def _gathered(tm, comp, e_cm, met_cm):
    cmap = comp if comp.ndim == 2 else comp[None, :]
    return e_cm[cmap, tm], met_cm[cmap, tm]


SHAPES = [(0, 7, 3, 4), (1, 5, 1, 3), (17, 14, 3, 6), (64, 15, 6, 7), (33, 54, 15, 7), (9, 130, 16, 5)]


@pytest.mark.parametrize("B,T,m,n", SHAPES)
@pytest.mark.parametrize("per_row", [False, True])
def test_closed_form_rates_shared_and_per_row(B, T, m, n, per_row):
    _, tm, comp, uir, e_cm, met_cm, cap = _problem(B + T, B, T, m, n, per_row, min(B, 3))
    e, met = _gathered(tm, comp, e_cm, met_cm)
    ref = rcm.closed_form_rates(tm, e, met, uir, cap)
    got = pcm.closed_form_rates(tm, comp, uir, e_cm, met_cm, cap, device="cpu")
    _assert_parity(got, ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_closed_form_rates_per_row_capacity_and_resources(seed):
    B, T, m, n = 29, 23, 7, 4
    rng, tm, comp, uir, e_cm, met_cm, _ = _problem(seed, B, T, m, n)
    cap_bm = rng.uniform(1.0, 12.0, size=(B, m))
    e, met = _gathered(tm, comp, e_cm, met_cm)
    _assert_parity(
        pcm.closed_form_rates(tm, comp, uir, e_cm, met_cm, cap_bm, device="cpu"),
        rcm.closed_form_rates(tm, e, met, uir, cap_bm),
    )
    net = rng.uniform(0.0, 0.5, size=(B, m))
    mem_c = rng.uniform(0.0, 2.0, size=n)
    mem_cap = rng.uniform(3.0, 12.0, size=m)
    mem_cap_bm = rng.uniform(3.0, 12.0, size=(B, m))
    mem_cap_bm[0] = 0.0  # a row over memory everywhere
    mem = mem_c[comp]
    for kw_ref, kw_port in [
        (dict(net_var=net), dict(net_var=net)),                      # network only
        (dict(mem=mem, mem_capacity=mem_cap), dict(mem_c=mem_c, mem_capacity=mem_cap)),
        (dict(net_var=net, mem=mem, mem_capacity=mem_cap_bm),        # both, per-row memory
         dict(net_var=net, mem_c=mem_c, mem_capacity=mem_cap_bm)),
    ]:
        ref = rcm.closed_form_rates(tm, e, met, uir, cap_bm, **kw_ref)
        got = pcm.closed_form_rates(tm, comp, uir, e_cm, met_cm, cap_bm, device="cpu", **kw_port)
        _assert_parity(got, ref)
    assert (ref[0] == 0.0).any()  # the memory mask is exercised


def _skew_pair(n_keys=12):
    r_utg = R.keyed_rolling_count_topology(n_keys=n_keys, zipf_s=1.1)
    p_utg = convert.user_graph(r_utg)

    def shares(n):
        return np.random.default_rng(100 + n).dirichlet(np.ones(n))

    edge = r_utg.groupings[0].edge
    return (
        r_utg, p_utg,
        rcm.SkewModel(r_utg, {edge: shares}),
        pcm.SkewModel(p_utg, {edge: shares}),
    )


@pytest.mark.parametrize("regime", ["shared", "per_row", "skew", "skew_per_row"])
@pytest.mark.parametrize("resources", [False, True])
def test_max_stable_rate_batch_matches(regime, resources):
    rng = np.random.default_rng(11)
    r_cl = R.paper_cluster((2, 2, 2))
    if resources:
        r_cl = R.paper_cluster((2, 2, 2), profile=R.paper_profile().with_mem(
            np.array([0.2, 1.0, 1.5, 2.0]))).with_resources(
            mem_capacity=np.full(6, 4.0),
            distance=R.rack_distance_matrix(np.array([0, 0, 1, 1, 2, 2]), 1.0, 3.0),
            net_penalty=0.4,
        )
    p_cl = convert.cluster(r_cl)
    skew = regime.startswith("skew")
    if skew:
        r_utg, p_utg, r_sk, p_sk = _skew_pair()
    else:
        r_utg = R.star_topology()
        p_utg = convert.user_graph(r_utg)
        r_sk = p_sk = None
    r_etg = R.schedule(r_utg, R.paper_cluster((2, 2, 2)), rate_epsilon=0.5).etg
    p_etg = convert.execution_graph(r_etg, p_utg)
    T = r_etg.total_tasks
    B = 40
    tm = rng.integers(0, 6, size=(B, T))
    n_inst = None
    if regime.endswith("per_row"):
        n_inst = np.tile(r_etg.n_instances, (B, 1))
        for b in range(B):  # move one instance between two components
            src, dst = rng.choice(np.flatnonzero(n_inst[b] > 1)), rng.integers(0, len(n_inst[b]))
            n_inst[b, src] -= 1
            n_inst[b, dst] += 1
    ref = rcm.max_stable_rate_batch(r_etg, r_cl, tm, backend="numpy", n_instances=n_inst, skew=r_sk)
    got = pcm.max_stable_rate_batch(p_etg, p_cl, tm, n_instances=n_inst, skew=p_sk, device="cpu")
    _assert_parity(got, ref, exact=not resources)
    assert P.max_stable_rate(p_etg, p_cl, skew=p_sk) == pytest.approx(
        R.max_stable_rate(r_etg, r_cl, skew=r_sk), rel=1e-12, abs=1e-12
    )


@pytest.mark.parametrize("per_row", [False, True])
def test_network_unit_load_matches_and_chunks(per_row):
    rng = np.random.default_rng(5)
    r_utg = R.diamond_topology(alpha=1.3)
    n, m, B = r_utg.n_components, 9, 37
    n_inst = np.array([1, 2, 3, 2, 3])
    T = int(n_inst.sum())
    cir = rcm.component_rates(r_utg, 1.0)
    if per_row:
        counts = np.tile(n_inst, (B, 1))
        counts[::2, 1] += 1
        counts[::2, 3] -= 1
        comp, uir = rcm.per_row_task_maps(cir, counts, T)
    else:
        comp = np.repeat(np.arange(n), n_inst)
        uir = (cir / n_inst)[comp]
    tm = rng.integers(0, m, size=(B, T))
    dist = np.asarray(R.rack_distance_matrix(rng.integers(0, 3, size=m), 1.0, 2.5))
    args = (tm, comp, uir, r_utg.alpha, cir, r_utg.edges, dist, 0.7)
    ref = rcm.network_unit_load(*args)
    whole = pcm.network_unit_load(*args, device="cpu").numpy()
    np.testing.assert_allclose(whole, ref, rtol=1e-12, atol=1e-14)
    # Row chunks never change a row's floats (the reference's guarantee).
    chunked = pcm.network_unit_load(*args, chunk_elems=2 * n * m, device="cpu").numpy()
    assert np.array_equal(chunked, whole)


def test_eq6_and_predict_match():
    r_etg = R.schedule(R.rolling_count_topology(), R.paper_cluster((2, 2, 2)), rate_epsilon=0.5).etg
    p_etg = convert.execution_graph(r_etg)
    r_cl, p_cl = R.paper_cluster((2, 2, 2)), P.paper_cluster((2, 2, 2))
    assert np.array_equal(pcm.component_rates(p_etg.utg, 3.5), rcm.component_rates(r_etg.utg, 3.5))
    assert np.array_equal(pcm.instance_rates(p_etg, 2.0), rcm.instance_rates(r_etg, 2.0))
    pp, rp = pcm.predict(p_etg, p_cl, 7.0), rcm.predict(r_etg, r_cl, 7.0)
    for field in ("ir", "tcu", "machine_util", "mac"):
        assert np.array_equal(getattr(pp, field), getattr(rp, field))
    assert pp.throughput == rp.throughput and pp.feasible == rp.feasible
    counts = np.array([[1, 3, 2], [2, 2, 2], [1, 1, 4]])
    for a, b in zip(pcm.per_row_task_maps(np.array([1.0, 4.0, 4.0]), counts, 6),
                    rcm.per_row_task_maps(np.array([1.0, 4.0, 4.0]), counts, 6)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("per_row", [False, True])
def test_resource_operands_match_reference(per_row):
    # The reference's surface: (net_var, mem per task in comp's shape,
    # mem_capacity); the port's scorer takes the per-component mem_c
    # through its private helper instead.
    rng = np.random.default_rng(12)
    r_cl = R.paper_cluster((2, 3, 2), profile=R.paper_profile().with_mem(
        np.array([0.2, 1.0, 1.5, 2.0]))).with_resources(
        mem_capacity=np.full(7, 4.0),
        distance=R.rack_distance_matrix(np.array([0, 0, 1, 1, 2, 2, 2]), 1.0, 3.0),
        net_penalty=0.4,
    )
    p_cl = convert.cluster(r_cl)
    utg = R.diamond_topology(alpha=1.3)
    n_inst = np.array([1, 2, 3, 2, 3])
    T, B = int(n_inst.sum()), 19
    cir = rcm.component_rates(utg, 1.0)
    if per_row:
        counts = np.tile(n_inst, (B, 1))
        counts[::3, 2] += 1
        counts[::3, 1] -= 1
        comp, uir = rcm.per_row_task_maps(cir, counts, T)
    else:
        comp = np.repeat(np.arange(utg.n_components), n_inst)
        uir = (cir / n_inst)[comp]
    tm = rng.integers(0, 7, size=(B, T))
    args = (tm, comp, uir, utg.alpha, cir, utg.edges, utg.component_types)
    r_net, r_mem, r_cap = rcm.resource_operands(r_cl, *args)
    p_net, p_mem, p_cap = pcm.resource_operands(p_cl, *args, device="cpu")
    assert p_mem.shape == comp.shape and np.array_equal(p_mem, r_mem)
    assert np.array_equal(p_cap, r_cap)
    np.testing.assert_allclose(p_net.numpy(), r_net, rtol=1e-12, atol=1e-14)
    # The scorer's helper hands the kernel the per-component vector.
    *_, mem_c, _ = pcm._scoring_operands(p_cl, *args, device="cpu")
    assert np.array_equal(mem_c[comp], p_mem)
