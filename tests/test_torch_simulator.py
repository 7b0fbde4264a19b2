"""Port parity: the batched back-pressure simulator against the reference's NumPy loop.

The torch fixed point sums in another order than the reference's per-task
``np.add.at``, so the contract is 1e-9 (rel and abs) on every output.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core import metrics as rmetrics  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import metrics as pmetrics  # noqa: E402

TOL = dict(rtol=1e-9, atol=1e-9)


def _assert_batch_close(got, ref):
    for field in ("ir", "pr", "tcu", "machine_util", "throughput"):
        a, b = getattr(got, field), getattr(ref, field)
        assert a.shape == b.shape, field
        np.testing.assert_allclose(a, b, **TOL, err_msg=field)


@pytest.mark.parametrize("topo", ["linear_topology", "diamond_topology", "star_topology",
                                  "rolling_count_topology"])
@pytest.mark.parametrize("counts", [(1, 1, 1), (2, 2, 2)])
def test_simulate_batch_matches_numpy(topo, counts):
    r_cl = R.paper_cluster(counts)
    r_etg = R.schedule(getattr(R, topo)(), r_cl, rate_epsilon=0.5).etg
    p_etg, p_cl = convert.execution_graph(r_etg), convert.cluster(r_cl)
    rng = np.random.default_rng(sum(counts))
    tm = rng.integers(0, r_cl.n_machines, size=(24, r_etg.total_tasks))
    tm[0] = r_etg.task_machine()
    rate, _ = R.max_stable_rate(r_etg, r_cl)
    for r0 in (0.5 * rate, rate, 3.0 * rate, rng.uniform(0.1, 4.0, size=24) * rate):
        ref = R.simulate_batch(r_etg, r_cl, tm, r0, backend="numpy")
        got = P.simulate_batch(p_etg, p_cl, tm, r0, device="cpu")
        _assert_batch_close(got, ref)


def test_simulate_batch_edge_shapes():
    r_cl = R.paper_cluster((1, 0, 0))  # a single machine
    r_etg = R.schedule(R.linear_topology(), r_cl, rate_epsilon=0.5).etg
    p_etg, p_cl = convert.execution_graph(r_etg), convert.cluster(r_cl)
    T = r_etg.total_tasks
    for tm, r0 in [
        (np.zeros((0, T), dtype=np.int64), 1.0),            # B = 0
        (np.zeros((0, T), dtype=np.int64), np.zeros(0)),    # B = 0, (B,) rates
        (np.zeros((1, T), dtype=np.int64), np.array([7.0])),  # (1,) rate vector
        (np.zeros((3, T), dtype=np.int64), 2.5),
    ]:
        ref = R.simulate_batch(r_etg, r_cl, tm, r0, backend="numpy")
        got = P.simulate_batch(p_etg, p_cl, tm, r0, device="cpu")
        _assert_batch_close(got, ref)
    with pytest.raises(ValueError):
        P.simulate_batch(p_etg, p_cl, np.zeros((2, T), dtype=np.int64), np.ones(3), device="cpu")
    with pytest.raises(ValueError):
        P.simulate_batch(p_etg, p_cl, np.zeros((2, T + 1), dtype=np.int64), 1.0, device="cpu")


def test_simulate_measured_tcu_and_metrics_match():
    r_cl = R.paper_cluster((2, 2, 2))
    r_etg = R.schedule(R.diamond_topology(), r_cl, rate_epsilon=0.5).etg
    p_etg, p_cl = convert.execution_graph(r_etg), convert.cluster(r_cl)
    r_sim = R.simulate(r_etg, r_cl, 11.0)
    p_sim = P.simulate(p_etg, p_cl, 11.0, device="cpu")
    assert p_sim.throughput == pytest.approx(r_sim.throughput, **{"rel": 1e-9, "abs": 1e-9})
    np.testing.assert_allclose(
        P.measured_tcu(p_etg, p_cl, 11.0, seed=3, device="cpu"),
        R.measured_tcu(r_etg, r_cl, 11.0, seed=3), **TOL,
    )
    assert pmetrics.weighted_utilization(p_etg, p_cl, p_sim) == pytest.approx(
        rmetrics.weighted_utilization(r_etg, r_cl, r_sim), rel=1e-9
    )
    util = pmetrics.per_machine_utilization(p_etg.task_machine(), p_sim.tcu, 6)
    np.testing.assert_allclose(util, p_sim.machine_util, **TOL)
    pred, meas = np.array([10.0, 50.0, 90.0]), np.array([12.0, 47.0, 91.0])
    assert pmetrics.prediction_accuracy(pred, meas) == rmetrics.prediction_accuracy(pred, meas)
    assert pmetrics.gain_ratio(30.0, 20.0, 0.6, 0.5) == rmetrics.gain_ratio(30.0, 20.0, 0.6, 0.5)
    lv = pmetrics.fairness_levels(np.array([2.0, 3.0]), np.array([4.0, 3.0]), np.array([1.0, 2.0]))
    assert np.array_equal(lv, rmetrics.fairness_levels(
        np.array([2.0, 3.0]), np.array([4.0, 3.0]), np.array([1.0, 2.0])))
    assert pmetrics.jain_index(lv) == rmetrics.jain_index(lv)


def test_fixed_point_matches_closed_form():
    """At the closed-form R* no machine throttles, so the simulated
    throughput equals the closed form's (the paper's consistency check)."""
    cl = P.paper_cluster((2, 2, 2))
    etg = P.schedule(P.star_topology(), cl, rate_epsilon=0.5).etg
    rate, thpt = P.max_stable_rate(etg, cl)
    sim = P.simulate(etg, cl, rate, device="cpu")
    assert sim.throughput == pytest.approx(thpt, rel=1e-9)
    assert np.all(sim.machine_util <= cl.capacity * (1 + 1e-9))
