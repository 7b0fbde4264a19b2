"""Wrapper of the policy-sweep kernel: checks, dispatch by device, launch count.

``policy_scan`` takes torch tensors that all lie on one device. On a CUDA
tensor it launches the hand-written kernel (``csrc/policy_scan.cu``) once;
on a CPU tensor it runs the plain PyTorch version (``ref.py``). There is no
fallback between the two: a launch that fails raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.policy_scan.ref import (
    ScanConfig,
    ScanOutput,
    ScanTopology,
    policy_scan_ref,
)
from repro_torch.kernels.sched_scoring.ops import _check

__all__ = [
    "LAUNCHES",
    "SMEM_LIMIT",
    "ScanConfig",
    "ScanOutput",
    "ScanTopology",
    "policy_scan",
    "reset_launches",
    "smem_bytes",
]

# Shared memory one block may use on Hopper: the kernel keeps a (b, p)
# pair's whole state there, so T and m are bounded by it (``smem_bytes``).
SMEM_LIMIT = 232_448

# Kernel launches since the last reset. Only a launch of the CUDA kernel
# counts; the CPU path and empty sweeps launch nothing.
LAUNCHES = {"policy_scan": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def smem_bytes(n_tasks: int, n_machines: int, n_components: int, n_keyed: int) -> int:
    """Shared-memory bytes of one block of the kernel, for the layout that
    ``csrc/policy_scan.cu`` carves (the launcher takes this count): five
    float64 per task, three per machine and per component, one per keyed
    edge, twelve scalars (three totals, the throttle, the queue maximum of
    each of the block's eight warps); an int32 per task and per machine
    boundary."""
    doubles = 5 * n_tasks + 3 * n_machines + 3 * n_components + max(n_keyed, 1) + 12
    return 8 * doubles + 4 * (n_tasks + n_machines + 1)


def policy_scan(
    rates: torch.Tensor,
    capacity: torch.Tensor,
    task_machine: torch.Tensor,
    e: torch.Tensor,
    met: torch.Tensor,
    shares: torch.Tensor,
    topo: ScanTopology,
    cfg: ScanConfig,
) -> ScanOutput:
    """The window step of B traces against P static placements, W windows.

    Args:
      rates: (B, W) float64 offered spout rate per window.
      capacity: (B, W, m) float64 machine capacity per window.
      task_machine: (P, T) int32 machine per task; ids outside [0, m) match
        no machine.
      e / met: (P, T) float64 eq. 5 slope and fixed cost of each task on
        its machine.
      shares: (B, W, S) float64 instance shares of the fields edges, laid
        end to end in ``topo.keyed`` order (S = ``topo.n_shares``).
      topo / cfg: the topology's static structure and the loop constants.

    Returns the (B, P, W) metrics and the (B, P, m) window-mean utilization.
    """
    dev = rates.device
    if rates.ndim != 2 or capacity.ndim != 3 or task_machine.ndim != 2:
        raise ValueError("rates must be (B, W), capacity (B, W, m), task_machine (P, T)")
    B, W = rates.shape
    P, T = task_machine.shape
    m = capacity.shape[2]
    if topo.n_tasks != T:
        raise ValueError(f"topology offsets {topo.offsets} do not cover {T} tasks")
    _check("rates", rates, torch.float64, ((B, W),), dev)
    _check("capacity", capacity, torch.float64, ((B, W, m),), dev)
    _check("task_machine", task_machine, torch.int32, ((P, T),), dev)
    _check("e", e, torch.float64, ((P, T),), dev)
    _check("met", met, torch.float64, ((P, T),), dev)
    _check("shares", shares, torch.float64, ((B, W, topo.n_shares),), dev)
    if B == 0 or P == 0 or W == 0:
        empty = torch.zeros((B, P, W), dtype=torch.float64, device=dev)
        return ScanOutput(empty, empty.clone(), empty.clone(), empty.clone(), empty.clone(),
                          torch.zeros((B, P, m), dtype=torch.float64, device=dev))
    # One limit on both devices, so a sweep the CPU runs also runs on a card.
    need = smem_bytes(T, m, topo.n_components, len(topo.keyed))
    if need > SMEM_LIMIT:
        raise ValueError(
            f"the policy_scan kernel keeps a (trace, placement) pair's state in one block's "
            f"shared memory: {T} tasks on {m} machines need {need} bytes, over {SMEM_LIMIT}")
    if B > 65_535:
        raise ValueError(f"the policy_scan kernel takes at most 65535 traces, got {B}")
    if dev.type == "cpu":
        return policy_scan_ref(rates, capacity, task_machine, e, met, shares, topo, cfg)
    if dev.type != "cuda":
        raise ValueError(f"policy_scan runs on cpu or cuda tensors, not {dev}")
    return _launch(rates, capacity, task_machine, e, met, shares, topo, cfg, need)


_TOPO: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}


def _device_topology(topo: ScanTopology, dev: torch.device) -> tuple[torch.Tensor, ...]:
    """The kernel's packed int32 topology (offsets, spout flags, parent
    lists, keyed edges) and alpha on ``dev``, made once per topology."""
    key = (topo, dev)
    got = _TOPO.get(key)
    if got is None:
        n = topo.n_components
        ptr = [0]
        for ps in topo.parents:
            ptr.append(ptr[-1] + len(ps))
        keyed, col = [], 0
        for par, lo, hi in topo.keyed:
            keyed += [par, lo, hi, col]
            col += hi - lo
        packed = [*topo.offsets, *(int(s) for s in topo.sources), *ptr,
                  *(q for ps in topo.parents for q in ps), *keyed]
        got = (torch.tensor(packed, dtype=torch.int32, device=dev),
               torch.tensor(topo.alpha, dtype=torch.float64, device=dev),
               torch.repeat_interleave(torch.arange(n, dtype=torch.int32, device=dev),
                                       torch.tensor(topo.counts, device=dev)))
        _TOPO[key] = got
    return got


def _launch(rates, capacity, tm, e, met, shares, topo, cfg, n_smem):
    from repro_torch.kernels.policy_scan.kernel import load_library

    lib = load_library()
    dev = rates.device
    B, W = rates.shape
    P, T = tm.shape
    m = capacity.shape[2]
    packed, alpha, comp = _device_topology(topo, dev)
    # Each placement's tasks grouped by machine, ascending task order within
    # a machine (a stable sort), and each machine's start in that order.
    sorted_tm, order = torch.sort(tm, dim=1, stable=True)
    bounds = torch.arange(m + 1, dtype=torch.int32, device=dev).expand(P, m + 1).contiguous()
    mstart = torch.searchsorted(sorted_tm, bounds).to(torch.int32)
    order = order.to(torch.int32)
    outs = [torch.empty((B, P, W), dtype=torch.float64, device=dev) for _ in range(5)]
    util = torch.empty((B, P, m), dtype=torch.float64, device=dev)
    n_edges = sum(len(ps) for ps in topo.parents)
    err = lib.policy_scan_launch(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        rates.data_ptr(), capacity.data_ptr(), tm.data_ptr(), e.data_ptr(), met.data_ptr(),
        order.data_ptr(), mstart.data_ptr(), comp.data_ptr(), alpha.data_ptr(),
        packed.data_ptr(), shares.data_ptr(), *(x.data_ptr() for x in outs), util.data_ptr(),
        B, P, T, m, topo.n_components, n_edges, len(topo.keyed), W, topo.n_shares,
        float(cfg.window_s), float(cfg.max_queue), float(cfg.bp_high), float(cfg.bp_low),
        float(cfg.throttle_down), float(cfg.throttle_up), float(cfg.throttle_min), n_smem,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"policy_scan kernel launch failed with CUDA error {err}")
    LAUNCHES["policy_scan"] += 1
    return ScanOutput(*outs, util)
