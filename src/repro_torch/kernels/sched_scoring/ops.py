"""Wrapper of the scheduling-score kernel: checks, dispatch by device, launch count.

``sched_scoring`` takes torch tensors that all lie on one device. On a CUDA
tensor it launches the hand-written kernel (``csrc/sched_scoring.cu``, the
port of ``repro/kernels/sched_scoring/kernel.py``'s two Pallas kernels);
on a CPU tensor it runs the plain PyTorch version (``ref.py``). There is no
fallback between the two: a launch that fails raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.sched_scoring.ref import sched_scoring_ref

__all__ = ["LAUNCHES", "machine_tiles", "max_machines", "max_table_tasks", "reset_launches",
           "sched_scoring", "scratch_bytes", "table_slots"]

# One block's shared memory on Hopper. The kernel keeps a row's m
# accumulators (CPU load, fixed load and, with a memory term, memory; 8 bytes
# each, and a 4-byte tag a machine) beside its staged task tiles, one row a
# block at the most: ``acc_doubles`` and ``warp_smem`` in
# ``csrc/sched_scoring.cu``, mirrored below with its tile constants. Past
# that m a row touches at most T machines, and the kernel keeps accumulators
# for those alone, in a table of ``table_slots`` slots a warp (a machine id
# each beside the accumulators, and a bit a machine), where that takes at
# most ``TILE_WARP_BYTES``; else it splits the machines into tiles whose warp
# takes at most ``TILE_WARP_BYTES``. That is a warp's share of an SM where
# eight one-warp blocks (each reserving 1 KB) share its 228 KB (``tile_width``
# there, ``machine_tiles`` here).
BLOCK_SMEM_BYTES = 227 * 1024
TILE_WARP_BYTES = 27 * 1024
_TT, _NSTAGE = 128, 2
_TS_I, _TS_D = _TT + 8, _TT + 4

# Kernel launches since the last reset, by variant. Only a launch of the
# CUDA kernel counts; the CPU path and B == 0 launch nothing.
LAUNCHES = {"sched_scoring": 0, "sched_scoring_resources": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _tile_bytes(row_comp: bool, row_uir: bool) -> int:
    return _NSTAGE * (_TS_I * 4 * (1 + row_comp) + _TS_D * 8 * row_uir)


def warp_smem(m: int, use_mem: bool, row_comp: bool, row_uir: bool) -> int:
    """Shared-memory bytes of one row (one warp) of the kernel."""
    acc_doubles = ((3 if use_mem else 2) * m + (m + 1) // 2 + 1) // 2 * 2
    return acc_doubles * 8 + _tile_bytes(row_comp, row_uir)


def table_bytes(slots: int, m: int, use_mem: bool, row_comp: bool, row_uir: bool) -> int:
    """Shared-memory bytes of one row's warp with a table of ``slots``
    slots on m machines: var, met (and mem) float64 and a machine id
    (int32) a slot and a bit a machine (int32 words), padded to 16 bytes,
    then the staged tiles."""
    acc = ((3 if use_mem else 2) * 8 + 4) * slots + 4 * -(-m // 32)
    return -(-acc // 16) * 16 + _tile_bytes(row_comp, row_uir)


def max_machines(use_mem: bool, row_comp: bool, row_uir: bool) -> int:
    """The largest m of the one-block layout: one row's shared memory within
    a block's. A larger m takes the machine-tiled layout (``machine_tiles``).

    ``use_mem``: a memory term; ``row_comp`` / ``row_uir``: (B, T) component
    and unit-rate maps in place of (T,) ones.
    """
    m = (BLOCK_SMEM_BYTES // 8) * 2 // (7 if use_mem else 5)  # 2.5 m or 3.5 m doubles alone
    while warp_smem(m + 1, use_mem, row_comp, row_uir) <= BLOCK_SMEM_BYTES:
        m += 1
    while warp_smem(m, use_mem, row_comp, row_uir) > BLOCK_SMEM_BYTES:
        m -= 1
    return m


def machine_tiles(m: int, use_mem: bool, row_comp: bool, row_uir: bool) -> tuple[int, int]:
    """(machines a tile, tiles a row) of the kernel's launch at m machines:
    (m, 1) up to ``max_machines`` (the one-block layout), else the most
    machines, a multiple of 32, whose warp takes at most ``TILE_WARP_BYTES``,
    and as many tiles as cover m (the last one may be narrower)."""
    if m <= max_machines(use_mem, row_comp, row_uir):
        return m, 1
    width = 32
    while warp_smem(width + 32, use_mem, row_comp, row_uir) <= TILE_WARP_BYTES:
        width += 32
    return width, -(-m // width)


def _slots(touched: int) -> int:
    # Linear probing under a load of 2/3, and always one free slot.
    return touched + touched // 2 + 1


def max_table_tasks(m: int, use_mem: bool, row_comp: bool, row_uir: bool) -> int:
    """The most machines a row may touch, min(T, m), for the table layout
    on m machines: its ``table_bytes`` within ``TILE_WARP_BYTES`` (-1 where
    not even an empty row's table fits)."""
    budget = TILE_WARP_BYTES - _tile_bytes(row_comp, row_uir) - 4 * -(-m // 32)
    most = budget // ((3 if use_mem else 2) * 8 + 4)  # the most slots
    s = max(2 * (most - 1) // 3, -1)
    while _slots(s + 1) <= most:
        s += 1
    while s >= 0 and _slots(s) > most:
        s -= 1
    return s


def table_slots(n_tasks: int, m: int, use_mem: bool, row_comp: bool, row_uir: bool) -> int:
    """The slots of the kernel's table layout at T tasks on m machines:
    past ``max_machines``, for min(T, m) up to ``max_table_tasks``; else 0,
    for the one-block layout or, past both, the machine-tiled one
    (``machine_tiles``)."""
    if m <= max_machines(use_mem, row_comp, row_uir):
        return 0
    touched = min(n_tasks, m)
    return _slots(touched) if touched <= max_table_tasks(m, use_mem, row_comp, row_uir) else 0


def scratch_bytes(B: int, n_tasks: int, m: int, use_mem: bool, row_comp: bool, row_uir: bool,
                  rows_m: bool) -> int:
    """Device scratch of the kernel's launch, which the wrapper allocates:
    the table layout's list of the machines that fail every row missing them
    and its count (int32, m + 1), where no (B, m) operand (``rows_m``: per-row
    capacity or memory capacity, or ``net_var``) streams every machine; the
    machine-tiled layout's partial min and flag of each (row, tile) (a
    float64 and an int32 each); else none."""
    flags = (use_mem, row_comp, row_uir)
    if m <= max_machines(*flags):
        return 0
    if table_slots(n_tasks, m, *flags):
        return 0 if rows_m else 4 * (m + 1)
    return B * machine_tiles(m, *flags)[1] * 12


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shapes: tuple, device) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) not in shapes:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected one of {shapes}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def sched_scoring(
    task_machine: torch.Tensor,
    comp: torch.Tensor,
    unit_ir: torch.Tensor,
    e_cm: torch.Tensor,
    met_cm: torch.Tensor,
    capacity: torch.Tensor,
    net_var: torch.Tensor | None = None,
    mem_c: torch.Tensor | None = None,
    mem_capacity: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B,) closed-form max stable rates of B candidate placements.

    Args:
      task_machine: (B, T) int32 machine id per task; ids outside [0, m)
        match no machine.
      comp / unit_ir: (T,) shared or (B, T) per-row component (int32) and
        unit-rate input (float64) per task.
      e_cm / met_cm: (n, m) float64 profile tables, gathered by the kernel.
      capacity: (m,) shared or (B, m) per-row CPU capacity.
      net_var: optional (B, m) cut-traffic load, added to the variable
        coefficient.
      mem_c / mem_capacity: optional (n,) per-instance memory demand and
        (m,) or (B, m) memory capacity — a hard feasibility mask.

    Any resource operand selects the resource variant of the kernel (a
    memory term needs both ``mem_c`` and ``mem_capacity``). Any m runs on
    both devices: on the card, past ``max_machines`` of the operands' layout,
    the kernel keeps a table of the machines a row touches
    (``table_slots``), or, past ``max_table_tasks`` tasks, takes the
    machine-tiled layout (``machine_tiles``), with the same bits.
    """
    dev = task_machine.device
    if task_machine.ndim != 2:
        raise ValueError("task_machine must be (B, T)")
    B, T = task_machine.shape
    n, m = e_cm.shape
    _check("task_machine", task_machine, torch.int32, ((B, T),), dev)
    _check("comp", comp, torch.int32, ((T,), (B, T)), dev)
    _check("unit_ir", unit_ir, torch.float64, ((T,), (B, T)), dev)
    _check("e_cm", e_cm, torch.float64, ((n, m),), dev)
    _check("met_cm", met_cm, torch.float64, ((n, m),), dev)
    _check("capacity", capacity, torch.float64, ((m,), (B, m)), dev)
    if net_var is not None:
        _check("net_var", net_var, torch.float64, ((B, m),), dev)
    if (mem_c is None) != (mem_capacity is None):
        raise ValueError("mem_c and mem_capacity go together")
    if mem_c is not None:
        _check("mem_c", mem_c, torch.float64, ((n,),), dev)
        _check("mem_capacity", mem_capacity, torch.float64, ((m,), (B, m)), dev)
    if B == 0:
        return torch.zeros(0, dtype=torch.float64, device=dev)
    if dev.type == "cpu":
        return sched_scoring_ref(
            task_machine, comp, unit_ir, e_cm, met_cm, capacity,
            net_var=net_var, mem_c=mem_c, mem_capacity=mem_capacity,
        )
    if dev.type != "cuda":
        raise ValueError(f"sched_scoring runs on cpu or cuda tensors, not {dev}")
    return _launch(task_machine, comp, unit_ir, e_cm, met_cm, capacity, net_var, mem_c, mem_capacity)


def _launch(tm, comp, unit_ir, e_cm, met_cm, capacity, net_var, mem_c, mem_capacity):
    from repro_torch.kernels.sched_scoring.kernel import load_library

    def ptr(x):
        return None if x is None else x.data_ptr()

    def row_stride(x):
        return 0 if x is None or x.ndim == 1 else x.shape[1]

    B, T = tm.shape
    m = e_cm.shape[1]
    # The kernel reads a (B, T) map by its row stride (T; 0 for a shared one).
    layout = (mem_c is not None, row_stride(comp) != 0, row_stride(unit_ir) != 0)
    slots = table_slots(T, m, *layout)
    tile_w = 0 if slots else machine_tiles(m, *layout)[0]
    rows_m = (net_var is not None or row_stride(capacity) != 0
              or (mem_c is not None and row_stride(mem_capacity) != 0))
    n_scratch = scratch_bytes(B, T, m, *layout, rows_m)
    scratch = torch.empty(n_scratch, dtype=torch.uint8, device=tm.device) if n_scratch else None
    lib = load_library()
    resources = net_var is not None or mem_c is not None
    out = torch.empty(B, dtype=torch.float64, device=tm.device)

    err = lib.sched_scoring_launch(
        tm.device.index if tm.device.index is not None else torch.cuda.current_device(),
        tm.data_ptr(), comp.data_ptr(), row_stride(comp),
        unit_ir.data_ptr(), row_stride(unit_ir),
        e_cm.data_ptr(), met_cm.data_ptr(),
        capacity.data_ptr(), row_stride(capacity),
        ptr(net_var), ptr(mem_c), ptr(mem_capacity), row_stride(mem_capacity),
        out.data_ptr(), ptr(scratch), n_scratch, B, T, m, tile_w, slots, int(resources),
        torch.cuda.current_stream(tm.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"sched_scoring kernel launch failed with CUDA error {err}")
    LAUNCHES["sched_scoring_resources" if resources else "sched_scoring"] += 1
    return out
