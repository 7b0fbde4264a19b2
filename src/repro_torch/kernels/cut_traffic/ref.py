"""Plain PyTorch version of the cut-traffic kernel.

The eager body that ``repro_torch.core.cost_model.network_unit_load`` ran
before the kernel existed, moved here as it was: per-task sender output and
receiver share, one ``scatter_add_`` per task column (every cell adds its
tasks in row order, the reference's ``np.add.at`` order bit for bit),
distance contractions summed in machine order (``_distance_contract``), the
edges in order, then the penalty. One rule was added to it: a task on an id
outside [0, m) matches no machine, as in the kernel (it adds into a spare
cell). ``csrc/cut_traffic.cu`` computes the same floats in the same order.

The CPU path of ``ops.cut_traffic`` runs it; ``chip_smoke.py`` holds the
CUDA kernel against it on the card.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["NET_CHUNK_ELEMS", "cut_traffic_ref"]

# Element cap for one row chunk of the accumulation: it materializes
# (B_chunk, n_components, n_machines) tensors plus the distance
# contractions, so wide topologies on large clusters would otherwise blow
# past the (B, T) sweep memory ``refine._SCORE_CHUNK`` budgets for. Rows are
# independent, so chunking never changes results.
NET_CHUNK_ELEMS = 4_000_000


def _distance_contract(x: torch.Tensor, dist_cols: torch.Tensor) -> torch.Tensor:
    """``y[..., w] = sum_v distance[w, v] * x[..., v]``, summed over v in
    increasing order with one rounding per product and per sum — the same
    bits on every device (a BLAS product would pick its own order)."""
    y = torch.zeros_like(x)
    tmp = torch.empty_like(x)
    for v in range(dist_cols.shape[0]):
        torch.mul(x[..., v : v + 1], dist_cols[v], out=tmp)
        y.add_(tmp)
    return y


def cut_traffic_ref(
    task_machine: torch.Tensor,          # (B, T) int; ids outside [0, m) match no machine
    comp: torch.Tensor,                  # (T,) or (B, T) int
    unit_ir: torch.Tensor,               # (T,) or (B, T) float64
    alpha: torch.Tensor,                 # (n,) float64
    cir_unit: torch.Tensor,              # (n,) float64
    edges: Sequence[tuple[int, int]],
    distance: torch.Tensor,              # (m, m) float64
    net_penalty: float = 1.0,
    chunk_elems: int = NET_CHUNK_ELEMS,
) -> torch.Tensor:
    """(B, m) per-machine cut-traffic load at unit topology rate.

    Row chunks are capped at ``chunk_elems`` (B_chunk·n·m) elements.
    """
    dev = task_machine.device
    f64 = torch.float64
    tm = task_machine.long()
    B, T = tm.shape
    n = cir_unit.shape[0]
    m = distance.shape[0]
    comp_t = comp.long()
    comp_bt = comp_t if comp_t.ndim == 2 else comp_t[None, :].expand(B, T)
    unit_bt = unit_ir if unit_ir.ndim == 2 else unit_ir[None, :].expand(B, T)
    # Per-task sender output and receiver share. A zero-input component
    # carries no flow; its receive fraction is moot.
    out_t = alpha[comp_bt] * unit_bt                         # (B, T)
    cir_of_t = cir_unit[comp_bt]
    rfrac_t = torch.where(
        cir_of_t > 0.0, unit_bt / cir_of_t.clamp_min(1e-300), torch.zeros_like(unit_bt)
    )
    # Ids outside [0, m) match no machine: their tasks add into a spare
    # cell past both halves of the masses, dropped below.
    valid = (tm >= 0) & (tm < m)
    dist_cols = distance.t().contiguous()
    srcs = sorted({a for a, _ in edges})
    dsts = sorted({b for _, b in edges})
    nm = n * m

    net = torch.empty((B, m), dtype=f64, device=dev)
    chunk = max(1, int(chunk_elems) // max(1, nm))
    for start in range(0, B, chunk):
        stop = min(start + chunk, B)
        bc = stop - start
        key = comp_bt[start:stop] * m + tm[start:stop]       # (bc, T)
        spare = torch.full_like(key, 2 * nm)
        send_key = torch.where(valid[start:stop], key, spare)
        recv_key = torch.where(valid[start:stop], key + nm, spare)
        # (T, bc, 2): per task column, the send and the receive cell of
        # every row — two distinct cells, so one scatter adds each once.
        keys = torch.stack([send_key, recv_key], dim=2).permute(1, 0, 2).contiguous()
        vals = torch.stack(
            [out_t[start:stop], rfrac_t[start:stop]], dim=2
        ).permute(1, 0, 2).contiguous()
        mass = torch.zeros((bc, 2 * nm + 1), dtype=f64, device=dev)
        for t in range(T):
            mass.scatter_add_(1, keys[t], vals[t])
        send = mass[:, :nm].view(bc, n, m)
        recv = mass[:, nm : 2 * nm].view(bc, n, m)
        # Distance contractions, only for components that send / receive:
        # the charge on machine w is sum_v distance[w, v] x (mass on v).
        d = _distance_contract(
            torch.cat([send[:, srcs, :], recv[:, dsts, :]], dim=1), dist_cols
        )
        send_d = {a: d[:, i, :] for i, a in enumerate(srcs)}
        recv_d = {b: d[:, len(srcs) + i, :] for i, b in enumerate(dsts)}
        acc = torch.zeros((bc, m), dtype=f64, device=dev)
        for a, b in edges:
            acc += send[:, a, :] * recv_d[b]                 # sender side
            acc += recv[:, b, :] * send_d[a]                 # receiver side
        net[start:stop] = acc
    return net * float(net_penalty)
