"""Freshness of ``chip_smoke.py``'s multi-tenant reference constants.

Phase 12 of the chip smoke holds the card against the reference's results
for the 100-tenant fleet (capacity x1 and x4), the 112 763-row relocation
sweep and the 15 215-row resource sweep; it cannot import ``repro``, so
those results are constants in the script. This test recomputes each from
``repro`` (``backend="numpy"``) with the script's own scenario functions, so
the constants cannot go stale. The multi-tenant runtime's constants are
recomputed in ``tests/test_torch_multitenant_runtime_golden.py``.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.multitenant as RMT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


@pytest.fixture(scope="module")
def fleet_x1():
    tenants, cluster = cs.mt_fleet(np, R, RMT, 100, 1.0)
    ms = RMT.schedule_tenants(tenants, cluster, validate=False, backend="numpy", **cs.FLEET_KW)
    return tenants, cluster, ms


def test_fleet_is_the_benchmarks(monkeypatch):
    """``mt_fleet`` builds ``benchmarks/bench_multitenant.py``'s fleet with
    its budgets."""
    monkeypatch.syspath_prepend(str(ROOT))
    sys.modules.pop("benchmarks", None)
    from benchmarks import bench_multitenant as bench

    ours, cluster = cs.mt_fleet(np, R, RMT, 100, 4.0)
    theirs = bench._fleet(100, np.random.default_rng(bench.SEED))
    assert bench.FLEET_KW == cs.FLEET_KW
    assert [(t.name, t.utg.name, t.target_rate, t.priority) for t in ours] == [
        (t.name, t.utg.name, t.target_rate, t.priority) for t in theirs]
    assert np.array_equal(cluster.capacity, R.paper_cluster((20, 30, 40)).capacity * 4.0)


@pytest.mark.parametrize("scale", [1, 4])
def test_fleet_constants(fleet_x1, scale):
    if scale == 1:
        ms = fleet_x1[2]
    else:
        tenants, cluster = cs.mt_fleet(np, R, RMT, 100, 4.0)
        ms = RMT.schedule_tenants(tenants, cluster, validate=False, backend="numpy",
                                  **cs.FLEET_KW)
    assert cs.fleet_summary(np, ms) == cs.MT_FLEET_REF[scale]


def test_relocation_sweep_constants(fleet_x1):
    tenants, cluster, ms = fleet_x1
    mt = cs.relocation_state(np, R, RMT, tenants, cluster, ms)
    sweeps = cs.relocation_sweeps(np, mt)
    scored = RMT.TenantBatchScorer(mt, backend="numpy").score(sweeps)
    assert cs.sweep_summary(np, scored) == cs.MT_RELOCATION_REF
    assert max(r.shape[1] for _, r in sweeps) == 84


def test_resource_sweep_constants():
    mt = cs.resource_state(np, R, RMT)
    assert mt.feasible()
    sweeps = cs.relocation_sweeps(np, mt)
    scored = RMT.TenantBatchScorer(mt, backend="numpy").score(sweeps)
    assert cs.sweep_summary(np, scored) == cs.MT_RESOURCE_REF
    assert len(sweeps) == 20 and all(r.shape[0] > 0 for _, r in sweeps)


def test_port_builds_the_same_cells():
    """The port's side of the scenario functions gives the reference's inputs: the
    same fleet, resource cluster and first assignment."""
    import repro_torch.core as P
    import repro_torch.multitenant as PMT

    ours, cluster = cs.mt_fleet(np, P, PMT, 100, 1.0)
    theirs, ref_cluster = cs.mt_fleet(np, R, RMT, 100, 1.0)
    assert [(t.name, t.target_rate, t.priority) for t in ours] == [
        (t.name, t.target_rate, t.priority) for t in theirs]
    assert np.array_equal(cluster.capacity, ref_cluster.capacity)
    mt, ref_mt = cs.resource_state(np, P, PMT), cs.resource_state(np, R, RMT)
    assert np.array_equal(mt.rates, ref_mt.rates)
    for st, ref_st in zip(mt.states, ref_mt.states):
        assert np.array_equal(st.task_machine(), ref_st.task_machine())
    assert np.array_equal(mt.cluster.distance, ref_mt.cluster.distance)
    assert np.array_equal(mt.cluster.mem_capacity, ref_mt.cluster.mem_capacity)
