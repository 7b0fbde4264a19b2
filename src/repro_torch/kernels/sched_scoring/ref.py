"""Plain PyTorch version of the scheduling-score kernel.

Computes exactly what ``csrc/sched_scoring.cu`` computes, on the same
un-gathered operands, with the same arithmetic in the same order: per-task
profile gathers, one ``scatter_add_`` per task column so every machine
accumulator adds its tasks in row order (bit-identical to NumPy's
``np.add.at`` in the reference ``cost_model.closed_form_rates``), then the
closed-form finalize. Memory stays O(B·m) — never the (B, m, T) one-hot.

The CPU tests run it against the reference; ``chip_smoke.py`` holds the
CUDA kernel against it on the card.
"""

from __future__ import annotations

import torch

__all__ = ["sched_scoring_ref"]


def sched_scoring_ref(
    task_machine: torch.Tensor,          # (B, T) int; ids outside [0, m) match no machine
    comp: torch.Tensor,                  # (T,) or (B, T) int
    unit_ir: torch.Tensor,               # (T,) or (B, T) float64
    e_cm: torch.Tensor,                  # (n, m) float64
    met_cm: torch.Tensor,                # (n, m) float64
    capacity: torch.Tensor,              # (m,) or (B, m) float64
    net_var: torch.Tensor | None = None,       # (B, m) cut-traffic load
    mem_c: torch.Tensor | None = None,         # (n,) per-instance memory
    mem_capacity: torch.Tensor | None = None,  # (m,) or (B, m)
) -> torch.Tensor:
    """(B,) max stable rates.

    ``rate_b = clip(min_{w: var_w > 0} (cap_w - met_w) / max(var_w, 1e-300), 0)``,
    or 0 when some ``cap_w - met_w < 0`` or (with memory) some
    ``mem_w > mem_cap_w``. ``net_var`` is added to ``var_w`` after the
    task accumulation, as in the reference.
    """
    B, T = task_machine.shape
    m = capacity.shape[-1]
    dev = task_machine.device
    f64 = torch.float64
    tm = task_machine.long()
    # Ids outside [0, m) match no machine: their tasks add into a spare
    # column m, dropped below.
    valid = (tm >= 0) & (tm < m)
    slot = torch.where(valid, tm, m)
    tm = torch.where(valid, tm, 0)
    comp_bt = (comp if comp.ndim == 2 else comp[None, :].expand(B, T)).long()
    uir = unit_ir if unit_ir.ndim == 2 else unit_ir[None, :].expand(B, T)
    ev = e_cm[comp_bt, tm] * uir
    met = met_cm[comp_bt, tm]
    mem = None
    if mem_c is not None and mem_capacity is not None:
        mem = mem_c[comp_bt]
    var_w = torch.zeros((B, m + 1), dtype=f64, device=dev)
    met_w = torch.zeros((B, m + 1), dtype=f64, device=dev)
    mem_w = torch.zeros((B, m + 1), dtype=f64, device=dev) if mem is not None else None
    for t in range(T):
        idx = slot[:, t : t + 1]
        var_w.scatter_add_(1, idx, ev[:, t : t + 1])
        met_w.scatter_add_(1, idx, met[:, t : t + 1])
        if mem_w is not None:
            mem_w.scatter_add_(1, idx, mem[:, t : t + 1])
    var_w, met_w = var_w[:, :m], met_w[:, :m]
    if mem_w is not None:
        mem_w = mem_w[:, :m]
    if net_var is not None:
        var_w = var_w + net_var
    cap_b = capacity if capacity.ndim == 2 else capacity[None, :]
    head = cap_b - met_w
    infeasible = (head < 0.0).any(dim=1)
    if mem_w is not None:
        mem_cap_b = mem_capacity if mem_capacity.ndim == 2 else mem_capacity[None, :]
        infeasible |= (mem_w > mem_cap_b).any(dim=1)
    inf = torch.tensor(float("inf"), dtype=f64, device=dev)
    limits = torch.where(var_w > 0.0, head / var_w.clamp_min(1e-300), inf)
    rates = limits.amin(dim=1) if m else torch.full((B,), float("inf"), dtype=f64, device=dev)
    return torch.where(infeasible, torch.zeros_like(rates), rates.clamp_min(0.0))
