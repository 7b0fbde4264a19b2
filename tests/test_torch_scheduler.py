"""Port parity: Algorithms 1+2, refine, optimal search and the baselines.

On its CPU path the port scores the reference's NumPy floats bit for bit,
so schedules, refine move lists and optimal searches must be *identical*
to ``repro``'s (scored with ``backend="numpy"``), not merely close.
"""

import hashlib

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core.refine import refine as r_refine  # noqa: E402
from repro.core.schedule_state import ScheduleState as RState  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core.schedule_state import ScheduleState as PState  # noqa: E402

TOPOLOGIES = ["linear_topology", "diamond_topology", "star_topology", "rolling_count_topology"]


def _same_etg(a, b):
    return (
        a.n_instances.tolist() == b.n_instances.tolist()
        and a.task_machine().tolist() == b.task_machine().tolist()
    )


def test_large_scenario_golden():
    """Paper's large scenario (20/70/90), the reference's frozen golden."""
    sched = P.schedule(P.linear_topology(), P.paper_cluster((20, 70, 90)), r0=1.0, rate_epsilon=1.0)
    assert sched.rate == 297.0
    assert sched.etg.n_instances.tolist() == [2, 56, 210, 210]
    assert sched.iterations == 46
    digest = hashlib.md5(sched.etg.task_machine().tobytes()).hexdigest()
    assert digest == "1dfed7471c737dcb63fc259cb03ffe02"


@pytest.mark.parametrize("topo", TOPOLOGIES)
@pytest.mark.parametrize("counts", [(1, 1, 1), (2, 2, 2), (10, 10, 10)])
def test_schedule_identical(topo, counts):
    eps = 1.0 if counts == (10, 10, 10) else 0.05
    ref = R.schedule(getattr(R, topo)(), R.paper_cluster(counts), rate_epsilon=eps)
    got = P.schedule(getattr(P, topo)(), P.paper_cluster(counts), rate_epsilon=eps)
    assert got.rate == ref.rate
    assert got.iterations == ref.iterations
    assert got.trace == ref.trace
    assert got.predicted_throughput == ref.predicted_throughput
    assert _same_etg(got.etg, ref.etg)


@pytest.mark.parametrize("topo", TOPOLOGIES)
@pytest.mark.parametrize("counts", [(1, 1, 1), (2, 2, 2)])
@pytest.mark.parametrize("eps", [0.5, 0.05])
def test_refine_identical_on_goldens(topo, counts, eps):
    r_cl = R.paper_cluster(counts)
    r_etg = R.schedule(getattr(R, topo)(), r_cl, rate_epsilon=eps).etg
    ref = r_refine(r_etg, r_cl, backend="numpy")
    got = P.refine(convert.execution_graph(r_etg), convert.cluster(r_cl), device="cpu")
    assert got.moves == ref.moves
    assert got.rate == ref.rate
    assert got.throughput == ref.throughput
    assert _same_etg(got.etg, ref.etg)


def test_refine_slow_suite_golden():
    cluster = P.paper_cluster((1, 1, 1))
    etg = P.schedule(P.linear_topology(), cluster, r0=1.0, rate_epsilon=0.05).etg
    res = P.refine(etg, cluster, device="cpu")
    assert res.moves == ["grow c2x3", "swap c1#0<->c3#1"]
    assert res.etg.n_instances.tolist() == [1, 1, 5, 4]
    assert res.throughput == pytest.approx(22.727405035657107, rel=1e-12)


@pytest.mark.parametrize("kwargs", [
    dict(allow_add=False),
    dict(adaptive_growth=True),
    dict(max_rounds=2),
])
def test_refine_options_identical(kwargs):
    r_cl = R.paper_cluster((2, 2, 2))
    r_etg = R.schedule(R.star_topology(), r_cl, rate_epsilon=0.5).etg
    ref = r_refine(r_etg, r_cl, backend="numpy", **kwargs)
    got = P.refine(convert.execution_graph(r_etg), convert.cluster(r_cl), device="cpu", **kwargs)
    assert got.moves == ref.moves
    assert got.throughput == ref.throughput
    assert _same_etg(got.etg, ref.etg)


def test_refine_skew_identical():
    r_utg = R.keyed_rolling_count_topology(n_keys=10, zipf_s=1.3)
    p_utg = convert.user_graph(r_utg)

    def shares(n):
        return np.random.default_rng(7 * n).dirichlet(np.ones(n) * 0.7)

    edge = r_utg.groupings[0].edge
    r_sk = R.SkewModel(r_utg, {edge: shares})
    p_sk = P.SkewModel(p_utg, {edge: shares})
    r_cl = R.paper_cluster((2, 2, 2))
    r_etg = R.schedule(r_utg, r_cl, rate_epsilon=0.5).etg
    ref = r_refine(r_etg, r_cl, backend="numpy", skew=r_sk)
    got = P.refine(convert.execution_graph(r_etg, p_utg), convert.cluster(r_cl), skew=p_sk,
                   device="cpu")
    assert got.moves == ref.moves
    assert got.throughput == ref.throughput
    assert _same_etg(got.etg, ref.etg)


def test_resource_cluster_schedule_and_refine():
    """Memory + rack distance: Alg. 1+2 identical; refine scores the network
    term to ~1e-16, so its result is held to 1e-12 and to feasibility."""
    mem = np.array([0.3, 1.0, 1.5, 2.0])
    dist = R.rack_distance_matrix(np.array([0, 0, 1, 1, 2, 2]), 1.0, 3.0)
    r_cl = R.paper_cluster((2, 2, 2), profile=R.paper_profile().with_mem(mem)).with_resources(
        mem_capacity=np.full(6, 5.0), distance=dist, net_penalty=0.2
    )
    p_cl = convert.cluster(r_cl)
    ref = R.schedule(R.diamond_topology(), r_cl, rate_epsilon=0.5)
    got = P.schedule(P.diamond_topology(), p_cl, rate_epsilon=0.5)
    assert got.rate == ref.rate and _same_etg(got.etg, ref.etg)
    r_res = r_refine(ref.etg, r_cl, backend="numpy", max_rounds=4)
    p_res = P.refine(got.etg, p_cl, max_rounds=4, device="cpu")
    assert p_res.throughput == pytest.approx(r_res.throughput, rel=1e-12)
    assert p_res.moves == r_res.moves
    state = PState.from_etg(p_res.etg, p_cl)
    assert np.all(state.mem_load <= p_cl.mem_capacity)


@pytest.mark.parametrize("prune", [True, False])
@pytest.mark.parametrize("max_per_machine", [None, 3])
def test_optimal_identical(prune, max_per_machine):
    kw = dict(max_total_tasks=6, max_per_machine=max_per_machine, prune_symmetry=prune)
    ref = R.optimal_schedule(R.linear_topology(), R.paper_cluster((2, 1, 1)), backend="numpy", **kw)
    got = P.optimal_schedule(P.linear_topology(), P.paper_cluster((2, 1, 1)), device="cpu", **kw)
    assert got.rate == ref.rate
    assert got.throughput == ref.throughput
    assert got.candidates_evaluated == ref.candidates_evaluated
    assert got.classes_pruned == ref.classes_pruned
    assert _same_etg(got.etg, ref.etg)


def test_optimal_slow_golden():
    opt = P.optimal_schedule(P.linear_topology(), P.paper_cluster((1, 1, 1)), max_total_tasks=8,
                             device="cpu")
    assert opt.candidates_evaluated == 26136
    assert opt.classes_pruned == 35
    assert opt.etg.n_instances.tolist() == [1, 2, 1, 3]
    assert opt.throughput == pytest.approx(23.268698060941833, rel=1e-12)
    assert P.placement_score(opt.etg, P.paper_cluster((1, 1, 1))) == opt.throughput


def test_round_robin_and_first_assignment_identical():
    r_cl = R.paper_cluster((2, 2, 2))
    for topo in TOPOLOGIES:
        ru, pu = getattr(R, topo)(), getattr(P, topo)()
        assert _same_etg(P.first_assignment(pu, P.paper_cluster((2, 2, 2)), 3.0),
                         R.first_assignment(ru, r_cl, 3.0))
        n_inst = np.arange(2, 2 + ru.n_components)
        for start in (0, 4):
            assert _same_etg(P.round_robin_schedule(pu, P.paper_cluster((2, 2, 2)), n_inst, start),
                             R.round_robin_schedule(ru, r_cl, n_inst, start))


def test_schedule_state_deltas_and_scoring_identical():
    r_cl = R.paper_cluster((2, 2, 2))
    r_etg = R.schedule(R.linear_topology(), r_cl, rate_epsilon=0.5).etg
    rs, ps = RState.from_etg(r_etg, r_cl), PState.from_etg(convert.execution_graph(r_etg),
                                                          convert.cluster(r_cl))
    for st in (rs, ps):
        st.add_instance(2, 4)
        st.relocate_instance(2, 0, 5)
        st.swap_instances(1, 0, 2, 1)
        st.drop_instance(3, 0)
    assert np.array_equal(ps.comp_counts, rs.comp_counts)
    assert np.array_equal(ps.task_machine(), rs.task_machine())
    for attr in ("met_load", "var_load", "mem_load", "net_load"):
        assert np.array_equal(getattr(ps, attr), getattr(rs, attr))
    assert ps.max_stable_rate() == rs.max_stable_rate()
    assert ps.max_stable_rate_exact() == rs.max_stable_rate_exact()
    dead = np.zeros(6, dtype=bool)
    dead[[1, 4]] = True
    assert ps.evacuate_machines(dead, 5.0) == rs.evacuate_machines(dead, 5.0)
    assert np.array_equal(ps.task_machine(), rs.task_machine())
    rng = np.random.default_rng(2)
    tm = rng.integers(0, 6, size=(50, ps.task_machine().shape[0]))
    got = ps.score_task_machine_batch(tm, device="cpu")
    ref = rs.score_task_machine_batch(tm, backend="numpy")
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])


def test_quickstart_port_prints_the_reference_numbers(capsys):
    import importlib.util
    from pathlib import Path

    from repro_torch import quickstart

    path = Path(__file__).resolve().parents[1] / "examples" / "quickstart.py"
    spec = importlib.util.spec_from_file_location("_reference_quickstart", path)
    reference = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reference)
    reference.main()
    ref_lines = capsys.readouterr().out.splitlines()
    quickstart.main(device="cpu")
    got_lines = capsys.readouterr().out.splitlines()
    assert got_lines[0] == ref_lines[0] + ", device cpu"
    assert got_lines[1:] == ref_lines[1:]
