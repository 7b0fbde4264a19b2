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


def _edge_problem(keyed, n_traces, W):
    """Task counts past the kernel's 96 threads a pair and not a multiple
    of them (126 shuffle tasks, 153 keyed, on 38 machines), ``n_traces``
    traces (blocks take 6), ``W`` windows."""
    cluster = P.paper_cluster((6, 14, 18))
    utg = (P.keyed_rolling_count_topology(n_keys=16, zipf_s=1.5) if keyed
           else P.linear_topology())
    etg = P.schedule(utg, cluster, r0=1.0, rate_epsilon=0.05).etg
    rate, _ = P.max_stable_rate(etg, cluster)
    rng = np.random.default_rng(7)
    policies = np.tile(etg.task_machine(), (10, 1))
    policies[1:, :] = rng.integers(0, cluster.n_machines, size=(9, etg.total_tasks))
    specs = [PS.ramp_trace(0.3 * rate, 1.6 * rate, n_windows=W),
             PS.failure_trace(0.9 * rate, machine=8, n_windows=W),
             PS.burst_trace(0.7 * rate, n_windows=W)]
    traces = [specs[k % 3].compile(cluster, seed=k, utg=utg) for k in range(n_traces)]
    return etg, cluster, traces, policies


@pytest.mark.cuda
@pytest.mark.parametrize("keyed, n_traces, W, outside", [
    (False, 7, 37, False),   # a block of 6 traces and one of 1; T = 126
    (True, 7, 37, True),     # keyed, ids outside [0, m); T = 153
    (False, 4, 1, True),     # one window
    (True, 2, 2, False),     # two windows, one block of 2 traces
])
def test_kernel_equals_plain_version_at_block_edges(cuda_device, keyed, n_traces, W, outside):
    etg, cluster, traces, policies = _edge_problem(keyed, n_traces, W)
    topo = scan_topology(etg)
    cfg = ops.ScanConfig(max_queue=120.0)
    cpu = _operands(etg, cluster, traces, policies, "cpu", outside)
    gpu = _operands(etg, cluster, traces, policies, cuda_device, outside)
    got = ops.policy_scan(*gpu, topo, cfg)
    again = ops.policy_scan(*gpu, topo, cfg)
    torch.cuda.synchronize()
    plain_cpu = ops.policy_scan(*cpu, topo, cfg)
    for name, g, a, w in zip(got._fields, got, again, plain_cpu):
        assert torch.equal(g, a), f"{name}: rerun differs"
        assert torch.equal(g.cpu(), w), f"{name}: differs from the plain version on the CPU"


@pytest.mark.cuda
def test_launcher_refuses_a_shared_memory_count_not_its_layouts(cuda_device, monkeypatch):
    """The wrapper's ``smem_bytes`` and the kernel's ``Layout`` describe one
    carve: a count off by one double is refused, not launched."""
    etg, cluster, traces, policies = _edge_problem(False, 2, 2)
    gpu = _operands(etg, cluster, traces, policies, cuda_device)
    real = ops.smem_bytes
    monkeypatch.setattr(ops, "smem_bytes", lambda *a, **k: real(*a, **k) + 8)
    with pytest.raises(RuntimeError, match="CUDA error 1$"):
        ops.policy_scan(*gpu, scan_topology(etg), ops.ScanConfig(max_queue=120.0))


def test_pairs_a_block_fit_shared_memory():
    """A block takes up to PAIRS_MAX traces of one placement, as many as
    its shared memory holds; at least one."""
    assert ops.pairs_a_block(6, 478, 180, 4, 0, 3) == 6
    assert ops.pairs_a_block(3, 478, 180, 4, 0, 3) == 3
    assert ops.pairs_a_block(20, 478, 180, 4, 0, 3) == ops.PAIRS_MAX
    wide = ops.pairs_a_block(6, 3000, 180, 4, 0, 3)
    assert 1 <= wide < 6
    assert ops.smem_bytes(3000, 180, 4, 0, wide, 3) <= ops.SMEM_LIMIT
    assert ops.smem_bytes(3000, 180, 4, 0, wide + 1, 3) > ops.SMEM_LIMIT
    assert ops.pairs_a_block(6, 6000, 180, 4, 0, 3) == 1


# Past one pair's shared memory (4 702 tasks on 180 machines, 5 813
# machines at 478 tasks, by ``smem_bytes``) the kernel's global-state
# instance takes a pair a block, over the min(T, m) machines a placement
# can occupy. By hand, for the linear topology's 4 components, 3 shuffle
# parents, no keyed edge, and its 16 worker warps: the small state is the
# totals' ring (2 x 4 x 256 doubles, 16 384 bytes) and 3 n + 1 + 16 + 2 =
# 31 doubles (248 bytes), the topology, 17 int32, with a count for each of
# the 18 warps (140 bytes): 16 772 in all. The per-task state is 3 T doubles
# and T int32 (28 T bytes); the per-machine state 4 occ + 1 doubles and
# 2 occ + 1 int32 (40 occ + 12 bytes), occ = min(T, m). Each goes to shared
# memory where it fits 232 448 bytes beside what is there, the per-task
# state first; the slab holds the copy of the backlog and the drops that the
# totals read (2 x T rounded up to 256 doubles) and what does not fit,
# doubles then int32, padded to 16 bytes.
#   (6 240, 180):    16 772 + 174 720 + 7 212 = 198 704 shared; 12 800 doubles of slab
#   (6 240, 16 380): 16 772 + 174 720 = 191 492 shared; 12 800 + 24 961 doubles
#                    and 12 481 int32 (6 241 doubles) -> 44 002 doubles of slab
#   (40, 16 380):    16 772 + 1 120 + 1 612 = 19 504 shared; 512 doubles of slab
#   (20 000, 180):   16 772 + 7 212 = 23 984 shared; 40 448 + 60 000 doubles and
#                    20 000 int32 -> 110 448 doubles of slab
def test_global_state_sizing_by_hand():
    assert not ops.state_in_global(4702, 180, 4, 0, 3) and ops.state_in_global(4703, 180, 4, 0, 3)
    assert not ops.state_in_global(478, 5813, 4, 0, 3) and ops.state_in_global(478, 5814, 4, 0, 3)
    assert ops.state_in_global(6240, 180, 4, 0, 3) and ops.state_in_global(40, 16380, 4, 0, 3)
    assert ops.global_smem_bytes(6240, 180, 4, 0, 3) == 198_704
    assert ops.global_smem_bytes(6240, 16380, 4, 0, 3) == 191_492
    assert ops.global_smem_bytes(40, 16380, 4, 0, 3) == 19_504
    assert ops.global_smem_bytes(20000, 180, 4, 0, 3) == 23_984
    assert ops.slab_bytes(6240, 180, 4, 0, 3) == 8 * 12_800
    assert ops.slab_bytes(6240, 16380, 4, 0, 3) == 8 * 44_002
    assert ops.slab_bytes(40, 16380, 4, 0, 3) == 8 * 512
    assert ops.slab_bytes(20000, 180, 4, 0, 3) == 8 * 110_448
    for T, m in ((6240, 180), (6240, 16380), (40, 16380), (20000, 180)):
        assert ops.slab_bytes(T, m, 4, 0, 3) % 16 == 0
        assert ops.global_smem_bytes(T, m, 4, 0, 3) <= ops.SMEM_LIMIT


# The splits by hand, with the sizes above: the per-task state fits while
# 16 772 + 28 T <= 232 448 (T <= 7 702); at 180 machines the per-machine
# state (7 212 bytes) fits beside it while 28 T <= 208 464 (T <= 7 445), and
# alone past 7 702 tasks; at 16 380 machines it fits only while 40 occ + 12
# <= 215 676 - 28 T, which no T past one block's state meets.
@pytest.mark.parametrize("T, m, split", [
    (6240, 180, (True, True)),
    (6240, 16380, (True, False)),
    (40, 16380, (True, True)),
    (20000, 180, (False, True)),
    (7445, 180, (True, True)),
    (7446, 180, (True, False)),
    (7702, 16380, (True, False)),
    (7703, 16380, (False, False)),
    (7703, 180, (False, True)),
])
def test_global_split_by_hand(T, m, split):
    assert ops.global_split(T, m, 4, 0, 3) == split
    shared = ops.global_smem_bytes(T, m, 4, 0, 3)
    assert shared == 16_772 + split[0] * 28 * T + split[1] * (40 * min(T, m) + 12)
    assert shared <= ops.SMEM_LIMIT


def test_wrapper_reaches_the_library_with_the_mirrors_layout(monkeypatch):
    """On each side of each boundary (one pair's block, then the global
    instance's two splits) the launcher hands the library the layout the
    mirrors pick: pairs a block (0 for the global-state instance) and its
    shared-memory count. Here the library is a stand-in that records the
    call and stops it, so no launch counts."""
    from repro_torch.kernels.policy_scan import kernel

    class Launching(Exception):
        pass

    calls = []

    class Library:
        @staticmethod
        def policy_scan_launch(*args):
            calls.append(args)
            raise Launching

    monkeypatch.setattr(kernel, "load_library", Library)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("Stream", (), {"cuda_stream": 0})())
    monkeypatch.setattr(ops, "_slab_blocks", lambda dev, pairs, smem: min(pairs, 132))
    base = 388 + 16_384  # the small state, the topology and the totals' ring
    for T, m, G, smem in ((4702, 180, 1, ops.smem_bytes(4702, 180, 4, 0, 1, 3)),
                          (4703, 180, 0, base + 28 * 4703 + 7212),
                          (7445, 180, 0, base + 28 * 7445 + 7212),
                          (7446, 180, 0, base + 28 * 7446),
                          (7702, 16380, 0, base + 28 * 7702),
                          (7703, 16380, 0, base)):
        operands, topo = _wide_operands(T, 1, 1, 2, (T - 3, 1, 1, 1), m, "cpu")
        before = dict(ops.LAUNCHES)
        with pytest.raises(Launching):
            ops._launch(*operands, topo, ops.ScanConfig())
        assert ops.LAUNCHES == before
        args = calls[-1]  # ..., B, P, T, m, n, E, K, W, S, G, 7 constants, slab, its
        assert args[17:27] == (1, 1, T, m, 4, 3, 0, 2, 0, G)  # blocks, smem, stream
        assert args[-2] == smem, (T, m)
        assert (args[-4] is None, args[-3]) == ((True, 0) if G else (False, 1)), (T, m)


def _wide_operands(seed, B, P, W, counts, m, device):
    """``chip_smoke.py``'s ``scan_problem``: the operands phase 22 holds the
    kernel to, so this test and the script cannot drift apart."""
    from torch_paper_common import chip_smoke

    return chip_smoke().scan_problem(torch, np, device, seed, B, P, W, counts, m)


@pytest.mark.cuda
@pytest.mark.parametrize("B, P, W, counts, m", [
    (3, 5, 12, (40, 2000, 2100, 2100), 180),       # 6 240 tasks: the x4 fleet's count
    (2, 3, 10, (10, 10, 10, 10), 16_380),          # 16 380 machines
    (2, 2, 6, (2, 4000, 4000, 3998), 180),         # 12 000 tasks
    (65_536, 1, 2, (1, 1, 1, 1), 3),               # 65 536 traces
    (6 * 65_535 + 7, 2, 2, (1, 1, 1, 1), 3),       # past the grid's 65 535 groups of 6
])
def test_kernel_equals_plain_version_past_one_block(cuda_device, B, P, W, counts, m):
    """Past one block's pair state, or past 65 535 groups of traces: one
    launch a call, equal to the plain version on the CPU bit for bit, rerun
    bit-identical."""
    gpu, topo = _wide_operands(sum(counts), B, P, W, counts, m, cuda_device)
    cpu = tuple(x.cpu() for x in gpu)
    cfg = ops.ScanConfig(max_queue=60.0)
    before = ops.LAUNCHES["policy_scan"]
    got = ops.policy_scan(*gpu, topo, cfg)
    again = ops.policy_scan(*gpu, topo, cfg)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["policy_scan"] == before + 2
    plain = ops.policy_scan(*cpu, topo, cfg)
    for name, g, a, w in zip(got._fields, got, again, plain):
        assert torch.equal(g, a), f"{name}: rerun differs"
        assert torch.equal(g.cpu(), w), f"{name}: differs from the plain version on the CPU"
    assert float(plain.throttle.min()) < 1.0 or B > 1000  # the queues push back


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "one machine occupied", "every machine occupied", "per-task state at its split",
    "per-task state past its split", "per-machine state at its split",
    "per-machine state past its split"])
def test_global_instance_equals_plain_version_at_edges(cuda_device, case):
    """``chip_smoke.py``'s edge shapes of the global-state instance: a
    placement on one machine, one on every machine, and task counts at each
    of its shared-memory splits and one past; equal to the plain version on
    the CPU bit for bit, rerun bit-identical."""
    from torch_paper_common import chip_smoke

    gpu, topo = chip_smoke().scan_edge_problem(torch, np, cuda_device, case)
    cfg = ops.ScanConfig(max_queue=60.0)
    got = ops.policy_scan(*gpu, topo, cfg)
    again = ops.policy_scan(*gpu, topo, cfg)
    torch.cuda.synchronize()
    plain = ops.policy_scan(*(x.cpu() for x in gpu), topo, cfg)
    for name, g, a, w in zip(got._fields, got, again, plain):
        assert torch.equal(g, a), f"{name}: rerun differs"
        assert torch.equal(g.cpu(), w), f"{name}: differs from the plain version on the CPU"


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
