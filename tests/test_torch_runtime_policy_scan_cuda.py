"""The policy-sweep kernel on a card (skipped without one).

``csrc/policy_scan.cu`` sums every task total in task order and each
machine's tasks in ascending task order, as the plain version does on the
CPU, so the kernel must equal the plain version run on the CPU bit for bit,
launch once a call, rerun bit-identically, and stay within 1e-12 of the
plain version run on the card (whose ``scatter_add_`` uses atomics).
JAX-free, so it runs where only torch is installed:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_runtime_policy_scan_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as P  # noqa: E402
import repro_torch.runtime_stream as PS  # noqa: E402
from repro_torch.kernels.policy_scan import ops  # noqa: E402
from repro_torch.kernels.policy_scan.ref import policy_scan_ref  # noqa: E402
from repro_torch.runtime_stream.eval_torch import (  # noqa: E402
    evaluate_policies_batch,
    scan_operands,
    scan_topology,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _problem(keyed, P_rows=24, W=90):
    cluster = P.paper_cluster((2, 3, 4))
    utg = (P.keyed_rolling_count_topology(n_keys=16, zipf_s=1.5) if keyed
           else P.rolling_count_topology())
    etg = P.schedule(utg, cluster, r0=1.0, rate_epsilon=0.05).etg
    rate, _ = P.max_stable_rate(etg, cluster)
    rng = np.random.default_rng(5)
    policies = np.tile(etg.task_machine(), (P_rows, 1))
    policies[1:, :] = rng.integers(0, cluster.n_machines, size=(P_rows - 1, etg.total_tasks))
    traces = [PS.ramp_trace(0.3 * rate, 1.6 * rate, n_windows=W).compile(cluster, seed=1,
                                                                           utg=utg),
              PS.failure_trace(0.9 * rate, machine=8, n_windows=W).compile(cluster, seed=2,
                                                                          utg=utg),
              PS.burst_trace(0.7 * rate, n_windows=W).compile(cluster, seed=3, utg=utg)]
    if keyed:
        traces.append(PS.skew_shift_trace(0.8 * rate, n_windows=W).compile(cluster, seed=4,
                                                                          utg=utg))
    return etg, cluster, traces, policies


def _operands(etg, cluster, traces, policies, device, outside=False):
    """``policy_scan``'s operands as ``evaluate_policies_batch`` builds them;
    with ``outside``, every 5th task on an id outside [0, m)."""
    operands, _, _ = scan_operands(etg, cluster, traces, policies, PS.RuntimeConfig(),
                                   torch.device(device))
    if outside:
        operands[2][:, ::5] = cluster.n_machines + 2
    return operands


@pytest.mark.cuda
@pytest.mark.parametrize("keyed", [False, True])
@pytest.mark.parametrize("outside", [False, True])
def test_kernel_equals_plain_version(cuda_device, keyed, outside):
    etg, cluster, traces, policies = _problem(keyed)
    topo = scan_topology(etg)
    cfg = ops.ScanConfig(max_queue=120.0)
    cpu = _operands(etg, cluster, traces, policies, "cpu", outside)
    gpu = _operands(etg, cluster, traces, policies, cuda_device, outside)
    before = ops.LAUNCHES["policy_scan"]
    got = ops.policy_scan(*gpu, topo, cfg)
    again = ops.policy_scan(*gpu, topo, cfg)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["policy_scan"] == before + 2
    plain_cpu = ops.policy_scan(*cpu, topo, cfg)
    plain_card = policy_scan_ref(*gpu, topo, cfg)
    for name, g, a, c, w in zip(got._fields, got, again, plain_card, plain_cpu):
        assert torch.equal(g, a), f"{name}: rerun differs"
        assert torch.equal(g.cpu(), w), f"{name}: differs from the plain version on the CPU"
        scale = max(1.0, float(c.abs().max()))
        assert float((g - c).abs().max()) <= 1e-12 * scale, name


@pytest.mark.cuda
def test_evaluator_launches_once_and_matches_executor(cuda_device):
    etg, cluster, traces, policies = _problem(True, P_rows=6, W=60)
    before = ops.LAUNCHES["policy_scan"]
    res = evaluate_policies_batch(etg, cluster, traces, policies,
                                  config=PS.RuntimeConfig(max_queue=120.0), device="cuda")
    assert ops.LAUNCHES["policy_scan"] == before + 1
    comp = etg.task_component()
    for b in (0, len(traces) - 1):
        for p in (0, 5):
            pe = P.ExecutionGraph(utg=etg.utg, n_instances=etg.n_instances.copy(),
                                  assignment=[policies[p][comp == c]
                                              for c in range(etg.utg.n_components)])
            run = PS.StreamExecutor(pe, cluster, traces[b],
                                    config=PS.RuntimeConfig(max_queue=120.0)).run()
            for field in ("throughput", "admitted", "dropped", "queue_total", "throttle"):
                np.testing.assert_allclose(getattr(res, field)[b, p], getattr(run, field),
                                           rtol=1e-9, atol=1e-9, err_msg=field)
            assert np.array_equal(res.throttle[b, p], run.throttle)
