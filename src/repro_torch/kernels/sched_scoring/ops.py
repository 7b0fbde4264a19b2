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

__all__ = ["LAUNCHES", "max_machines", "reset_launches", "sched_scoring"]

# One block's shared memory on Hopper. The kernel keeps a row's m
# accumulators (CPU load, fixed load and, with a memory term, memory; 8 bytes
# each, and a 4-byte tag a machine) beside its staged task tiles, one row a
# block at the most: ``acc_doubles`` and ``warp_smem`` in
# ``csrc/sched_scoring.cu``, mirrored below with its tile constants.
BLOCK_SMEM_BYTES = 227 * 1024
_TT, _NSTAGE = 128, 2
_TS_I, _TS_D = _TT + 8, _TT + 4

# Kernel launches since the last reset, by variant. Only a launch of the
# CUDA kernel counts; the CPU path and B == 0 launch nothing.
LAUNCHES = {"sched_scoring": 0, "sched_scoring_resources": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def warp_smem(m: int, use_mem: bool, row_comp: bool, row_uir: bool) -> int:
    """Shared-memory bytes of one row (one warp) of the kernel."""
    acc_doubles = ((3 if use_mem else 2) * m + (m + 1) // 2 + 1) // 2 * 2
    tiles = _NSTAGE * (_TS_I * 4 * (1 + row_comp) + _TS_D * 8 * row_uir)
    return acc_doubles * 8 + tiles


def max_machines(use_mem: bool, row_comp: bool, row_uir: bool) -> int:
    """The largest m the kernel takes: one row's shared memory within a block's.

    ``use_mem``: a memory term; ``row_comp`` / ``row_uir``: (B, T) component
    and unit-rate maps in place of (T,) ones.
    """
    m = (BLOCK_SMEM_BYTES // 8) * 2 // (7 if use_mem else 5)  # 2.5 m or 3.5 m doubles alone
    while warp_smem(m + 1, use_mem, row_comp, row_uir) <= BLOCK_SMEM_BYTES:
        m += 1
    while warp_smem(m, use_mem, row_comp, row_uir) > BLOCK_SMEM_BYTES:
        m -= 1
    return m


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
    memory term needs both ``mem_c`` and ``mem_capacity``). On the card m is
    at most ``max_machines`` of the operands' layout, and a larger m raises
    a ``ValueError`` that names the limit before any launch; the plain
    version on the CPU scores any m.
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

    B, T = tm.shape
    m = e_cm.shape[1]
    limit = max_machines(mem_c is not None, comp.ndim == 2, unit_ir.ndim == 2)
    if m > limit:
        raise ValueError(f"the sched_scoring kernel takes at most {limit} machines with these "
                         f"operands (one row's accumulators and tiles in one block's "
                         f"{BLOCK_SMEM_BYTES} bytes of shared memory), got {m}")
    lib = load_library()
    resources = net_var is not None or mem_c is not None
    out = torch.empty(B, dtype=torch.float64, device=tm.device)

    def ptr(x):
        return None if x is None else x.data_ptr()

    def row_stride(x):
        return 0 if x is None or x.ndim == 1 else x.shape[1]

    err = lib.sched_scoring_launch(
        tm.device.index if tm.device.index is not None else torch.cuda.current_device(),
        tm.data_ptr(), comp.data_ptr(), row_stride(comp),
        unit_ir.data_ptr(), row_stride(unit_ir),
        e_cm.data_ptr(), met_cm.data_ptr(),
        capacity.data_ptr(), row_stride(capacity),
        ptr(net_var), ptr(mem_c), ptr(mem_capacity), row_stride(mem_capacity),
        out.data_ptr(), B, T, m, int(resources),
        torch.cuda.current_stream(tm.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"sched_scoring kernel launch failed with CUDA error {err}")
    LAUNCHES["sched_scoring_resources" if resources else "sched_scoring"] += 1
    return out
