"""Wrapper of the cut-traffic kernel: checks, dispatch by device, launch count.

``cut_traffic`` takes torch tensors that all lie on one device. On a CUDA
tensor it launches the hand-written kernel (``csrc/cut_traffic.cu``); on a
CPU tensor it runs the plain PyTorch version (``ref.py``). There is no
fallback between the two: a launch that fails raises.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels.cut_traffic.ref import NET_CHUNK_ELEMS, cut_traffic_ref
from repro_torch.kernels.sched_scoring.ops import _check

__all__ = ["LAUNCHES", "MAX_MACHINES", "W_TILE", "cut_traffic", "distance_tiles", "edge_slots",
           "reset_launches"]

# The largest m whose distance tiles span all m machines: two one-column
# tiles (2 x 8 bytes a machine, m padded to 64) in one block's 227 KB of
# shared memory. Past it the kernel splits the tiles along the machines w
# too, W_TILE at a time (nine warp tiles of 64 machines: three 8-column
# tiles in flight take 111 KB, so two blocks share an SM). Any m and any
# number of contracted components run (past shared memory, the masses and
# their contraction go to a global scratch).
MAX_MACHINES = 227 * 1024 // (2 * 8) // 64 * 64
W_TILE = 9 * 64

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


def distance_tiles(m: int) -> tuple[int, int]:
    """(machines w a distance tile, tiles along w) of the kernel's step 3 at
    m machines: all of them in one, padded to 64, up to ``MAX_MACHINES``;
    else ``W_TILE`` at a time (``plan_launch``'s ``wt`` in
    ``csrc/cut_traffic.cu``)."""
    if m <= MAX_MACHINES:
        return -(-m // 64) * 64, 1
    return W_TILE, -(-m // W_TILE)


_SLOTS: dict[tuple, tuple[torch.Tensor, ...]] = {}


def _device_slots(edges: tuple, n: int, dev: torch.device) -> tuple:
    """``edge_slots`` as int32 tensors on ``dev`` and the number of slots,
    made once per topology."""
    key = (edges, n, dev)
    slots = _SLOTS.get(key)
    if slots is None:
        send_slot, recv_slot, pairs = edge_slots(edges, n)
        k2 = sum(s >= 0 for s in send_slot) + sum(s >= 0 for s in recv_slot)
        slots = tuple(torch.tensor(x, dtype=torch.int32, device=dev).reshape(shape)
                      for x, shape in ((send_slot, (n,)), (recv_slot, (n,)),
                                       (pairs, (len(pairs), 2)))) + (k2,)
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
      distance: (m, m) float64 machine distances; any m (on a card, past
        ``MAX_MACHINES`` the kernel tiles them along w: ``distance_tiles``).
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
    send_slot, recv_slot, pairs, k2 = _device_slots(edges, n, tm.device)
    out = torch.empty((B, m), dtype=torch.float64, device=tm.device)

    def row_stride(x):
        return 0 if x.ndim == 1 else x.shape[1]

    err = lib.cut_traffic_launch(
        tm.device.index if tm.device.index is not None else torch.cuda.current_device(),
        tm.data_ptr(), comp.data_ptr(), row_stride(comp), unit_ir.data_ptr(), row_stride(unit_ir),
        alpha.data_ptr(), cir_unit.data_ptr(), send_slot.data_ptr(), recv_slot.data_ptr(),
        pairs.data_ptr(), len(edges), k2, distance.data_ptr(), float(net_penalty), out.data_ptr(),
        B, T, n, m, torch.cuda.current_stream(tm.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"cut_traffic kernel launch failed with CUDA error {err}")
    LAUNCHES["cut_traffic"] += 1
    return out
