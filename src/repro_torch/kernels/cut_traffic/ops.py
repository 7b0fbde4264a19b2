"""Wrapper of the cut-traffic kernel: checks, dispatch by device, launch count.

``cut_traffic`` takes torch tensors that all lie on one device. On a CUDA
tensor it launches the hand-written kernel (``csrc/cut_traffic.cu``); on a
CPU tensor it runs the plain PyTorch version (``ref.py``). There is no
fallback between the two: a launch that fails raises.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels.cut_traffic.ref import NET_CHUNK_ELEMS, cut_traffic_ref
from repro_torch.kernels.sched_scoring.ops import _check

__all__ = ["GROUP_ROWS", "LAUNCHES", "W_TILE", "WAVE_BYTES", "contracted_lists", "cut_traffic",
           "distance_tiles", "edge_slots", "list_columns", "list_wave", "one_block",
           "reset_launches"]

# The list layout, past the one-block layouts (``one_block``): rows a group
# (the rows that share each list and each distance tile), machines w a
# product block's distance tile, and the most bytes a wave of groups takes
# of scratch (at least one group).
GROUP_ROWS = 32
W_TILE = 128
WAVE_BYTES = 384 << 20

# Kernel launches since the last reset. Only a launch of the CUDA kernel
# counts; the CPU path and B == 0 launch nothing.
LAUNCHES = {"cut_traffic": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def edge_slots(edges: Sequence[tuple[int, int]], n: int) -> tuple[list, list, list]:
    """The kernel's slot maps of a topology: (send_slot, recv_slot) per
    component (its row of the contracted masses, the sending components
    first in increasing order, then the receiving ones; -1 where it has
    none) and, per edge in order, (send slot of a, receive slot of b)."""
    srcs = sorted({a for a, _ in edges})
    dsts = sorted({b for _, b in edges})
    send_slot, recv_slot = [-1] * n, [-1] * n
    for i, a in enumerate(srcs):
        send_slot[a] = i
    for i, b in enumerate(dsts):
        recv_slot[b] = len(srcs) + i
    return send_slot, recv_slot, [(send_slot[a], recv_slot[b]) for a, b in edges]


def contracted_lists(edges: Sequence[tuple[int, int]], n: int) -> tuple[list, list, int]:
    """The list layout's lists of a topology: one a contracted component
    (one that sends or receives), those with both slots first, each part in
    increasing component order. Returns (list_of per component, -1 where it
    has none; the (send, receive) slots of each list, -1 for a missing one,
    the two-slot lists' first; the number of two-slot lists)."""
    send_slot, recv_slot, _ = edge_slots(edges, n)
    both = [c for c in range(n) if send_slot[c] >= 0 and recv_slot[c] >= 0]
    one = [c for c in range(n) if (send_slot[c] >= 0) != (recv_slot[c] >= 0)]
    list_of = [-1] * n
    slots = []
    for j, c in enumerate(both + one):
        list_of[c] = j
        slots.append((send_slot[c], recv_slot[c]) if c in both
                     else (max(send_slot[c], recv_slot[c]), -1))
    return list_of, slots, len(both)


# plan_launch's shared-memory sums of the one-block layouts (csrc/cut_traffic.cu).
_BLOCK_MAX = 227 * 1024
_NT_MAX = 288
_STAGED_BYTES = 1024  # one warp's staging area of the mass phase


@functools.lru_cache(maxsize=256)
def one_block(m: int, k2: int) -> bool:
    """Whether the kernel takes m machines and k2 slots in one of its
    one-block layouts (X^T and Y^T in shared memory), as ``plan_launch``
    decides; else the list layout. At k2 = 6 up to 1 600 machines."""
    mp = -(-m // 64) * 64

    def items(rows):
        return 32 * -(-(-(-rows * k2 // 6)) // 2) * (mp // 64)

    def smem(rows, kt, apart):
        xy = 8 * mp * (-(-rows * k2 // 6) * 6)
        region = max(_STAGED_BYTES * (_NT_MAX // 32), 8 * 3 * kt * (mp + 2))
        return 2 * xy + region if apart else xy + max(region, xy)

    rows = 8
    while rows > 1 and (items(rows) > _NT_MAX or 2 * smem(rows, 8, False) > _BLOCK_MAX):
        rows //= 2
    return smem(rows, 2, items(rows) > _NT_MAX) <= _BLOCK_MAX


def distance_tiles(m: int, k2: int) -> tuple[int, int]:
    """(machines w a distance tile, tiles along w) of the kernel's step 3 at
    m machines and k2 slots: all of them in one, padded to 64, in the
    one-block layouts; else ``W_TILE`` at a time."""
    if one_block(m, k2):
        return -(-m // 64) * 64, 1
    return W_TILE, -(-m // W_TILE)


def list_wave(B: int, k2: int, m: int, n_lists: int) -> tuple[int, int]:
    """(rows a wave, scratch bytes) of the list layout for B rows: as many
    whole groups as ``WAVE_BYTES`` holds (at least one, at most the groups
    of B); (0, 0) in the one-block layouts. A wave's scratch is its rows'
    X and Y (k2 x m float64 each a row) and, a group, its lists (m int32
    each), bitmaps and lengths; then the non-finite columns' bitmap
    (``list_scratch_bytes`` in ``csrc/cut_traffic.cu``). It does not grow
    with B past one wave."""
    if one_block(m, k2):
        return 0, 0
    words = -(-m // 32)
    per_group = 16 * GROUP_ROWS * k2 * m + 4 * n_lists * (m + words + 1)
    groups = max(1, min(-(-B // GROUP_ROWS), WAVE_BYTES // max(per_group, 1)))
    return groups * GROUP_ROWS, groups * per_group + 4 * words


def list_columns(task_machine: np.ndarray, comp: np.ndarray, edges: Sequence[tuple[int, int]],
                 n: int, nonfinite: np.ndarray, group_rows: int = GROUP_ROWS) -> list:
    """The list layout's lists, on the host: for each group of
    ``group_rows`` rows and each list of ``contracted_lists``, the sorted
    columns v where a row of the group has a task of the list's component
    (ids in [0, m)), with every column whose ``nonfinite`` flag is set (a
    column of ``distance`` with an inf or a NaN)."""
    B, T = task_machine.shape
    m = nonfinite.shape[0]
    comp = np.broadcast_to(comp, (B, T))
    list_of, slots, _ = contracted_lists(edges, n)
    lists = []
    for g0 in range(0, B, group_rows):
        tm, cg = task_machine[g0:g0 + group_rows], comp[g0:g0 + group_rows]
        valid = (tm >= 0) & (tm < m)
        occupied = np.zeros((len(slots), m), dtype=bool)
        for c, j in enumerate(list_of):
            if j >= 0:
                occupied[j, tm[valid & (cg == c)]] = True
        lists.append([np.flatnonzero(row | nonfinite) for row in occupied])
    return lists


_SLOTS: dict[tuple, tuple] = {}


def _device_slots(edges: tuple, n: int, dev: torch.device) -> tuple:
    """``edge_slots`` and ``contracted_lists`` as int32 tensors on ``dev``,
    with the number of slots and of two-slot lists, made once per
    topology."""
    key = (edges, n, dev)
    slots = _SLOTS.get(key)
    if slots is None:
        send_slot, recv_slot, pairs = edge_slots(edges, n)
        list_of, list_slots, n2 = contracted_lists(edges, n)
        k2 = sum(s >= 0 for s in send_slot) + sum(s >= 0 for s in recv_slot)
        slots = tuple(torch.tensor(x, dtype=torch.int32, device=dev).reshape(shape)
                      for x, shape in ((send_slot, (n,)), (recv_slot, (n,)),
                                       (pairs, (len(pairs), 2)), (list_of, (n,)),
                                       (list_slots, (len(list_slots), 2)))) + (k2, n2)
        _SLOTS[key] = slots
    return slots


def cut_traffic(
    task_machine: torch.Tensor,
    comp: torch.Tensor,
    unit_ir: torch.Tensor,
    alpha: torch.Tensor,
    cir_unit: torch.Tensor,
    edges: Sequence[tuple[int, int]],
    distance: torch.Tensor,
    net_penalty: float = 1.0,
    chunk_elems: int = NET_CHUNK_ELEMS,
) -> torch.Tensor:
    """(B, m) float64 cut-traffic load of B candidate placements at unit rate.

    Args:
      task_machine: (B, T) int32 machine id per task; ids outside [0, m)
        match no machine.
      comp / unit_ir: (T,) shared or (B, T) per-row component (int32, in
        [0, n)) and unit-rate input (float64) per task.
      alpha / cir_unit: (n,) float64 output ratio and unit-rate input of
        each component.
      edges: the topology's (a, b) component pairs, in order.
      distance: (m, m) float64 machine distances; any m and any values (on a
        card, past ``one_block`` the kernel's list layout multiplies only the
        columns that hold a task of a group's rows, or an inf or a NaN).
      net_penalty: CPU points per unit of cut flow and distance.
      chunk_elems: row-chunk cap of the plain version (CPU only; results
        never depend on it).
    """
    dev = task_machine.device
    if task_machine.ndim != 2:
        raise ValueError("task_machine must be (B, T)")
    if distance.ndim != 2 or distance.shape[0] != distance.shape[1]:
        raise ValueError(f"distance must be square (m, m), got {tuple(distance.shape)}")
    B, T = task_machine.shape
    n, m = alpha.shape[0], distance.shape[0]
    _check("task_machine", task_machine, torch.int32, ((B, T),), dev)
    _check("comp", comp, torch.int32, ((T,), (B, T)), dev)
    _check("unit_ir", unit_ir, torch.float64, ((T,), (B, T)), dev)
    _check("alpha", alpha, torch.float64, ((n,),), dev)
    _check("cir_unit", cir_unit, torch.float64, ((n,),), dev)
    _check("distance", distance, torch.float64, ((m, m),), dev)
    edges = tuple((int(a), int(b)) for a, b in edges)
    for a, b in edges:
        if not (0 <= a < n and 0 <= b < n):
            raise ValueError(f"edge {(a, b)} is out of range for {n} components")
    if B == 0:
        return torch.zeros((0, m), dtype=torch.float64, device=dev)
    if dev.type == "cpu":
        return cut_traffic_ref(task_machine, comp, unit_ir, alpha, cir_unit, edges, distance,
                               net_penalty, chunk_elems)
    if dev.type != "cuda":
        raise ValueError(f"cut_traffic runs on cpu or cuda tensors, not {dev}")
    return _launch(task_machine, comp, unit_ir, alpha, cir_unit, edges, distance, net_penalty)


def _launch(tm, comp, unit_ir, alpha, cir_unit, edges, distance, net_penalty):
    from repro_torch.kernels.cut_traffic.kernel import load_library

    lib = load_library()
    B, T = tm.shape
    n, m = alpha.shape[0], distance.shape[0]
    send_slot, recv_slot, pairs, list_of, list_slots, k2, n2 = _device_slots(edges, n, tm.device)
    n_lists = list_slots.shape[0]
    out = torch.empty((B, m), dtype=torch.float64, device=tm.device)
    # Past the one-block layouts, the waves' scratch comes from torch's
    # allocator: the launch allocates nothing itself.
    wave_rows, scratch_bytes = list_wave(B, k2, m, n_lists)
    scratch = (torch.empty(scratch_bytes, dtype=torch.uint8, device=tm.device)
               if scratch_bytes else None)

    def row_stride(x):
        return 0 if x.ndim == 1 else x.shape[1]

    err = lib.cut_traffic_launch(
        tm.device.index if tm.device.index is not None else torch.cuda.current_device(),
        tm.data_ptr(), comp.data_ptr(), row_stride(comp), unit_ir.data_ptr(), row_stride(unit_ir),
        alpha.data_ptr(), cir_unit.data_ptr(), send_slot.data_ptr(), recv_slot.data_ptr(),
        pairs.data_ptr(), len(edges), k2, list_of.data_ptr(), list_slots.data_ptr(), n_lists, n2,
        distance.data_ptr(), float(net_penalty), out.data_ptr(), B, T, n, m,
        scratch.data_ptr() if scratch is not None else None, scratch_bytes, wave_rows,
        torch.cuda.current_stream(tm.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"cut_traffic kernel launch failed with CUDA error {err}")
    LAUNCHES["cut_traffic"] += 1
    return out
