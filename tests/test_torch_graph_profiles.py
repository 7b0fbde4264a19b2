"""Port parity: graphs and profiles of ``repro_torch.core`` against ``repro.core``.

Every topology builder, the paper's profile and clusters, the resource
fields and the reference-to-port converter must give arrays equal to the
reference's.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core import convert  # noqa: E402

BUILDERS = [
    ("linear_topology", {}),
    ("linear_topology", {"alpha": 1.7}),
    ("diamond_topology", {}),
    ("star_topology", {"alpha": 0.5}),
    ("rolling_count_topology", {}),
    ("keyed_rolling_count_topology", {"n_keys": 16, "zipf_s": 0.8, "state_per_tuple": 3.0}),
    ("unique_visitor_topology", {}),
    ("wide_fanout_topology", {"n_mid": 5}),
]


def _assert_utg_equal(p, r):
    assert p.name == r.name
    assert np.array_equal(p.component_types, r.component_types)
    assert p.component_types.dtype == r.component_types.dtype
    assert np.array_equal(p.alpha, r.alpha)
    assert p.edges == r.edges
    assert [
        (g.edge, g.n_keys, g.zipf_s, g.state_per_tuple) for g in p.groupings
    ] == [(g.edge, g.n_keys, g.zipf_s, g.state_per_tuple) for g in r.groupings]
    assert p.topo_order() == r.topo_order()
    assert p.sources == r.sources
    assert p.keyed_components == r.keyed_components
    for i in range(p.n_components):
        assert p.parents(i) == r.parents(i)
        assert p.children(i) == r.children(i)


@pytest.mark.parametrize("name,kwargs", BUILDERS)
def test_topology_builders_match(name, kwargs):
    p = getattr(P, name)(**kwargs)
    r = getattr(R, name)(**kwargs)
    _assert_utg_equal(p, r)
    _assert_utg_equal(convert.user_graph(r), r)


@pytest.mark.parametrize("counts", [(1, 1, 1), (2, 2, 2), (2, 1, 1), (20, 70, 90)])
def test_paper_cluster_matches(counts):
    p, r = P.paper_cluster(counts), R.paper_cluster(counts)
    assert np.array_equal(p.machine_types, r.machine_types)
    assert np.array_equal(p.capacity, r.capacity)
    assert np.array_equal(p.profile.e, r.profile.e)
    assert np.array_equal(p.profile.met, r.profile.met)
    assert p.profile.type_names == r.profile.type_names
    assert p.profile.machine_type_names == r.profile.machine_type_names
    types = np.array([0, 3, 1, 2, 2])
    assert np.array_equal(p.e_for(types), r.e_for(types))
    assert np.array_equal(p.met_for(types), r.met_for(types))
    assert np.array_equal(p.mem_for(types), r.mem_for(types))


def test_resource_fields_match():
    rng = np.random.default_rng(3)
    rack = rng.integers(0, 3, size=12)
    assert np.array_equal(P.rack_distance_matrix(rack, 1.0, 4.0), R.rack_distance_matrix(rack, 1.0, 4.0))
    mem = np.array([0.5, 1.0, 2.0, 3.0])
    mem_cap = rng.uniform(2.0, 9.0, size=12)
    dist = R.rack_distance_matrix(rack)
    r = R.paper_cluster((4, 4, 4), profile=R.paper_profile().with_mem(mem)).with_resources(
        mem_capacity=mem_cap, distance=dist, net_penalty=0.3
    )
    p = P.paper_cluster((4, 4, 4), profile=P.paper_profile().with_mem(mem)).with_resources(
        mem_capacity=mem_cap, distance=dist, net_penalty=0.3
    )
    for c in (p, convert.cluster(r)):
        assert (c.has_memory, c.has_network, c.has_resources) == (True, True, True)
        assert np.array_equal(c.mem_capacity, r.mem_capacity)
        assert np.array_equal(c.distance, r.distance)
        assert c.net_penalty == r.net_penalty
        assert np.array_equal(c.profile.mem, r.profile.mem)
    keep = np.array([0, 5, 6, 11])
    ps, rs = p.subcluster(keep), r.subcluster(keep)
    assert np.array_equal(ps.distance, rs.distance)
    assert np.array_equal(ps.mem_capacity, rs.mem_capacity)
    assert np.array_equal(ps.machine_types, rs.machine_types)
    cap = rng.uniform(50, 100, size=12)
    assert np.array_equal(p.with_capacity(cap).capacity, r.with_capacity(cap).capacity)
    assert not p.without_network().has_network
    with pytest.raises(ValueError):
        P.Cluster(machine_types=p.machine_types, capacity=p.capacity, profile=p.profile,
                  distance=np.ones((12, 12)))


def test_execution_graph_matches():
    r_etg = R.schedule(R.diamond_topology(), R.paper_cluster((2, 2, 2)), rate_epsilon=0.5).etg
    p_etg = convert.execution_graph(r_etg)
    assert np.array_equal(p_etg.task_component(), r_etg.task_component())
    assert np.array_equal(p_etg.task_machine(), r_etg.task_machine())
    assert np.array_equal(p_etg.component_offsets(), r_etg.component_offsets())
    assert p_etg.total_tasks == r_etg.total_tasks
    grown_p, grown_r = p_etg.with_new_instance(2, 4), r_etg.with_new_instance(2, 4)
    assert np.array_equal(grown_p.task_machine(), grown_r.task_machine())
    assert np.array_equal(grown_p.n_instances, grown_r.n_instances)
    with pytest.raises(ValueError):
        P.ExecutionGraph(utg=p_etg.utg, n_instances=np.zeros(5), assignment=[np.zeros(0)] * 5)
