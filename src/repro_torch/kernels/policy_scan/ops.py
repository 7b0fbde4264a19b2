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
    "global_smem_bytes",
    "global_split",
    "policy_scan",
    "pairs_a_block",
    "reset_launches",
    "slab_bytes",
    "smem_bytes",
    "state_in_global",
]

# Shared memory one block may use on Hopper. The kernel keeps its pairs'
# whole state there where one pair's fits (``smem_bytes``); past that, its
# global-state instance takes one pair a block, over the machines that hold
# a task alone, and keeps the state that does not fit shared memory in a
# global scratch, one slab a resident block (``state_in_global``,
# ``global_split``, ``global_smem_bytes``, ``slab_bytes``), so any T and m
# run.
SMEM_LIMIT = 232_448

# Pairs (one placement, several traces) a block of the kernel takes, at
# most, and its worker warps a pair (PAIRS_MAX and WPP in
# ``csrc/policy_scan.cu``); the global-state instance's worker warps, all on
# its one pair (NWG there).
PAIRS_MAX = 6
WARPS_A_PAIR = 3
GLOBAL_WORKER_WARPS = 16

# Kernel launches since the last reset. Only a launch of the CUDA kernel
# counts; the CPU path and empty sweeps launch nothing.
LAUNCHES = {"policy_scan": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def smem_bytes(n_tasks: int, n_machines: int, n_components: int, n_keyed: int,
               pairs: int = 1, n_parents: int = 0) -> int:
    """Shared-memory bytes of one block of the kernel with ``pairs`` pairs,
    for the layout that ``csrc/policy_scan.cu`` carves (the launcher takes
    this count, and refuses one that is not its own ``Layout::bytes``): the
    placement's e and met (a float64 per task), the
    machines' fixed loads and alpha; per pair a float64 per task for
    backlog, processed and dropped, three per machine (one more for the
    tasks on no machine), two per component, one per keyed edge, each worker
    warp's deepest queue, the throttle and the admitted rate; an int32 per
    task for its machine and its place in the order, per machine boundary,
    and the packed topology (``n_parents`` shuffle parents in all)."""
    T, m, n, K = n_tasks, n_machines, n_components, n_keyed
    pair = 3 * T + 3 * m + 1 + 2 * n + max(K, 1) + WARPS_A_PAIR + 2
    ints = 2 * T + (m + 2) + (3 * n + 2 + n_parents + 4 * K)
    return 8 * (2 * T + m + n + pairs * pair) + 4 * ints


def state_in_global(n_tasks: int, n_machines: int, n_components: int, n_keyed: int,
                    n_parents: int = 0) -> bool:
    """Whether the kernel takes the pairs with its global-state instance:
    one pair's block (``smem_bytes`` with ``pairs=1``) past ``SMEM_LIMIT``."""
    return smem_bytes(n_tasks, n_machines, n_components, n_keyed, 1, n_parents) > SMEM_LIMIT


# The global-state instance's totals read a copy of a pair's backlog and
# drops through a ring of RING_CHUNKS chunks of CHUNK doubles an array (kRing
# and kChunk in ``csrc/policy_scan.cu``).
RING_CHUNKS, CHUNK = 4, 256


def _global_parts(n_tasks: int, n_machines: int, n_components: int, n_keyed: int,
                  n_parents: int) -> tuple[tuple[int, int], ...]:
    """(doubles, int32) of the global-state instance's three parts
    (``GlobalLayout`` in ``csrc/policy_scan.cu``): always in shared memory,
    the totals' ring, alpha, arrivals a component, prev_out, the fields
    edges' flows, each worker warp's deepest queue, the throttle and the
    admitted rate, the packed topology and a count a warp (all the block's
    warps); a pair's per-task state (backlog, processed, dropped; each
    task's place in the list of occupied machines); and the per-machine
    state of the min(T, m) machines a placement can occupy (capacities,
    scales with one for the tasks on no machine, utilization, fixed loads;
    the listed machines' ids and their starts in the task order, one more
    for the end)."""
    T, n, K = n_tasks, n_components, n_keyed
    occ = min(T, n_machines)
    small = (2 * RING_CHUNKS * CHUNK + 3 * n + max(K, 1) + GLOBAL_WORKER_WARPS + 2,
             (3 * n + 2 + n_parents + 4 * K) + (GLOBAL_WORKER_WARPS + 2))
    return small, (3 * T, T), (4 * occ + 1, 2 * occ + 1)


def global_split(n_tasks: int, n_machines: int, n_components: int, n_keyed: int,
                 n_parents: int = 0) -> tuple[bool, bool]:
    """(per-task state, per-machine state) in shared memory, in the
    global-state instance: each part where it fits ``SMEM_LIMIT`` beside
    what is already there, the per-task state first (the chains read it)."""
    small, task, mach = _global_parts(n_tasks, n_machines, n_components, n_keyed, n_parents)

    def size(part):
        return 8 * part[0] + 4 * part[1]

    task_smem = size(small) + size(task) <= SMEM_LIMIT
    mach_smem = size(small) + task_smem * size(task) + size(mach) <= SMEM_LIMIT
    return task_smem, mach_smem


def global_smem_bytes(n_tasks: int, n_machines: int, n_components: int, n_keyed: int,
                      n_parents: int = 0) -> int:
    """Shared-memory bytes of a block of the global-state instance
    (``GlobalLayout::smem_bytes`` in ``csrc/policy_scan.cu``): the pair's
    small state and the topology, and the parts that ``global_split`` puts
    in shared memory."""
    args = (n_tasks, n_machines, n_components, n_keyed, n_parents)
    small, task, mach = _global_parts(*args)
    task_smem, mach_smem = global_split(*args)
    return (8 * (small[0] + task_smem * task[0] + mach_smem * mach[0])
            + 4 * (small[1] + task_smem * task[1] + mach_smem * mach[1]))


def slab_bytes(n_tasks: int, n_machines: int, n_components: int, n_keyed: int,
               n_parents: int = 0) -> int:
    """Global bytes of one resident block's slab in the global-state
    instance (``GlobalLayout::slab_doubles``): the copy of the backlog and
    the drops that the totals read (two arrays of T doubles, T rounded up to
    ``CHUNK``), then the parts that ``global_split`` leaves out of shared
    memory, doubles then int32, padded to 16 bytes."""
    args = (n_tasks, n_machines, n_components, n_keyed, n_parents)
    _, task, mach = _global_parts(*args)
    task_smem, mach_smem = global_split(*args)
    copy = 2 * -(-n_tasks // CHUNK) * CHUNK
    doubles = copy + (not task_smem) * task[0] + (not mach_smem) * mach[0]
    ints = (not task_smem) * task[1] + (not mach_smem) * mach[1]
    return 8 * ((doubles + (ints + 1) // 2 + 1) // 2 * 2)


def pairs_a_block(B: int, n_tasks: int, n_machines: int, n_components: int, n_keyed: int,
                  n_parents: int = 0) -> int:
    """Pairs a block: the most, up to ``PAIRS_MAX`` and B, whose shared
    memory fits one block (at least 1)."""
    g = min(B, PAIRS_MAX)
    while g > 1 and smem_bytes(n_tasks, n_machines, n_components, n_keyed, g,
                               n_parents) > SMEM_LIMIT:
        g -= 1
    return g


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
    Any T, m and B run on both devices: on the card, past one pair's
    ``smem_bytes`` the global-state instance takes the pair (``state_in_
    global``: its occupied machines alone, what does not fit shared memory
    in a slab a block, ``global_split``), and the traces past the grid's
    65 535 groups go to its third axis.
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
    if dev.type == "cpu":
        return policy_scan_ref(rates, capacity, task_machine, e, met, shares, topo, cfg)
    if dev.type != "cuda":
        raise ValueError(f"policy_scan runs on cpu or cuda tensors, not {dev}")
    return _launch(rates, capacity, task_machine, e, met, shares, topo, cfg)


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


_RESIDENT: dict[tuple, int] = {}


def _slab_blocks(dev: torch.device, pairs: int, smem: int) -> int:
    """Blocks (and slabs) of a global-state launch: the resident ones at
    ``smem`` bytes (``kernel.occupancy``, once a device and size), at most
    the pairs."""
    from repro_torch.kernels.policy_scan.kernel import occupancy

    index = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (index, smem)
    if key not in _RESIDENT:
        _RESIDENT[key] = occupancy(1 << 30, 1, 0, smem, index)["blocks"]
    return min(pairs, _RESIDENT[key])


def _launch(rates, capacity, tm, e, met, shares, topo, cfg):
    from repro_torch.kernels.policy_scan.kernel import load_library

    lib = load_library()
    dev = rates.device
    B, W = rates.shape
    P, T = tm.shape
    m = capacity.shape[2]
    packed, alpha, comp = _device_topology(topo, dev)
    # Each placement's tasks grouped by machine, ascending task order within
    # a machine (a stable sort), the tasks on no machine last; each
    # machine's start in that order, and theirs.
    key = torch.where((tm >= 0) & (tm < m), tm, m)
    sorted_key, order = torch.sort(key, dim=1, stable=True)
    bounds = torch.arange(m + 2, dtype=torch.int32, device=dev).expand(P, m + 2).contiguous()
    mstart = torch.searchsorted(sorted_key, bounds).to(torch.int32)
    order = order.to(torch.int32)
    outs = [torch.empty((B, P, W), dtype=torch.float64, device=dev) for _ in range(5)]
    util = torch.empty((B, P, m), dtype=torch.float64, device=dev)
    n_edges = sum(len(ps) for ps in topo.parents)
    n, K = topo.n_components, len(topo.keyed)
    slab, blocks = None, 0
    if state_in_global(T, m, n, K, n_edges):  # G = 0: the global-state instance
        G, smem = 0, global_smem_bytes(T, m, n, K, n_edges)
        blocks = _slab_blocks(dev, B * P, smem)
        slab = torch.empty(blocks * slab_bytes(T, m, n, K, n_edges) // 8, dtype=torch.float64,
                           device=dev)
    else:
        G = pairs_a_block(B, T, m, n, K, n_edges)
        smem = smem_bytes(T, m, n, K, G, n_edges)
    err = lib.policy_scan_launch(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        rates.data_ptr(), capacity.data_ptr(), e.data_ptr(), met.data_ptr(), order.data_ptr(),
        mstart.data_ptr(), comp.data_ptr(), alpha.data_ptr(),
        packed.data_ptr(), shares.data_ptr(), *(x.data_ptr() for x in outs), util.data_ptr(),
        B, P, T, m, n, n_edges, K, W, topo.n_shares, G,
        float(cfg.window_s), float(cfg.max_queue), float(cfg.bp_high), float(cfg.bp_low),
        float(cfg.throttle_down), float(cfg.throttle_up), float(cfg.throttle_min),
        None if slab is None else slab.data_ptr(), blocks, smem,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"policy_scan kernel launch failed with CUDA error {err}")
    LAUNCHES["policy_scan"] += 1
    return ScanOutput(*outs, util)
