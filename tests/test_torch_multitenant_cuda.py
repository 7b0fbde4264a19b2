"""The tenant-batched scorer on a card (skipped without one).

``TenantBatchScorer(device="cuda")`` scores rows of different tenants in
one B1 launch (per-row component maps and capacity), or one B2 launch
with one cut_traffic launch for each non-empty tenant sweep on a
memory- and network-modelled cluster. Both kernels keep the plain
versions' sums, so the card must equal ``device="cpu"`` bit for bit.
JAX-free, so it runs where only torch is installed:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_multitenant_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as P  # noqa: E402
from repro_torch.core.schedule_state import ScheduleState  # noqa: E402
from repro_torch.kernels.cut_traffic import ops as cut_ops  # noqa: E402
from repro_torch.kernels.sched_scoring import ops  # noqa: E402
from repro_torch.multitenant import (  # noqa: E402
    MultiTenantState,
    Tenant,
    TenantBatchScorer,
    TenantSet,
    schedule_tenants,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _tenants():
    return [
        Tenant(name="alice", utg=P.linear_topology(), target_rate=8.0, priority=2.0),
        Tenant(name="bob", utg=P.diamond_topology(), target_rate=8.0),
        Tenant(name="carol", utg=P.star_topology(), target_rate=6.0),
        Tenant(name="dave", utg=P.rolling_count_topology(), target_rate=5.0),
    ]


def _cluster(resources):
    cluster = P.paper_cluster((3, 3, 4))
    if not resources:
        return cluster
    m = cluster.n_machines
    return P.Cluster(
        machine_types=cluster.machine_types, capacity=cluster.capacity,
        profile=cluster.profile.with_mem(np.array([0.5, 1.0, 1.5, 2.0])),
        mem_capacity=np.full(m, 6.0), distance=P.rack_distance_matrix(np.arange(m) % 2),
        net_penalty=0.05,
    )


def _state(resources):
    """Four tenants at 0.9 of their fair allocation on a scalar cluster;
    on the resource cluster (where the water filling does not price cut
    traffic) first-assigned at half their residual R*."""
    cluster = _cluster(resources)
    tenants = _tenants()
    if resources:
        mt = MultiTenantState.first_assignment(TenantSet(tenants), cluster)
        mt.rates = np.array([0.5 * mt.residual_rstar(t) for t in range(len(tenants))])
        return mt
    ms = schedule_tenants(tenants, cluster, device="cpu", warm_refine_rounds=4)
    states = [ScheduleState.from_etg(a.etg, cluster) for a in ms.allocations]
    return MultiTenantState(TenantSet(tenants), cluster, states, rates=ms.rates * 0.9)


def _sweeps(mt, rng, rows_each=40):
    sweeps = []
    for t, st in enumerate(mt.states):
        base = st.task_machine()
        rows = np.tile(base, (rows_each, 1))
        rows[np.arange(rows_each), rng.integers(0, base.size, rows_each)] = rng.integers(
            0, mt.cluster.n_machines, rows_each)
        sweeps.append((t, rows))
    sweeps.insert(1, (2, np.zeros((0, mt.states[2].task_machine().size), np.int64)))
    return sweeps


@pytest.mark.cuda
@pytest.mark.parametrize("resources", [False, True], ids=["scalar", "memory+network"])
def test_card_scores_equal_the_cpu(cuda_device, resources):
    mt = _state(resources)
    sweeps = _sweeps(mt, np.random.default_rng(3))
    ops.reset_launches()
    cut_ops.reset_launches()
    got = TenantBatchScorer(mt, device="cuda").score(sweeps)
    want = TenantBatchScorer(mt, device="cpu").score(sweeps)
    n_nonempty = sum(r.shape[0] > 0 for _, r in sweeps)
    expected = (
        {"sched_scoring": 0, "sched_scoring_resources": 1, "cut_traffic": n_nonempty}
        if resources else {"sched_scoring": 1, "sched_scoring_resources": 0, "cut_traffic": 0}
    )
    assert {**ops.LAUNCHES, **cut_ops.LAUNCHES} == expected
    for (r_g, h_g), (r_c, h_c) in zip(got, want):
        np.testing.assert_array_equal(r_g, r_c)
        np.testing.assert_array_equal(h_g, h_c)
    assert got[1][0].shape == (0,)
    assert any(np.any(r > 0) for r, _ in got)


@pytest.mark.cuda
def test_card_schedule_tenants_equals_the_cpu(cuda_device):
    cluster = _cluster(False)
    a = schedule_tenants(_tenants(), cluster, device="cuda", warm_refine_rounds=4)
    b = schedule_tenants(_tenants(), cluster, device="cpu", warm_refine_rounds=4)
    np.testing.assert_array_equal(a.rates, b.rates)
    assert a.log == b.log and a.rounds == b.rounds
    for x, y in zip(a.allocations, b.allocations):
        np.testing.assert_array_equal(x.etg.task_machine(), y.etg.task_machine())
