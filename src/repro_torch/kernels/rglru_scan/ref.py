"""Plain PyTorch versions of the RG-LRU scan kernel and its backward (the
forward is the port of ``repro/kernels/rglru_scan/ref.py``)."""

from __future__ import annotations

import torch

__all__ = ["rglru_scan_bwd_ref", "rglru_scan_ref"]


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1 from h0, a sequential loop.

    a, b: (B, S, W); h0: (B, W). The carry is float32; every h_t is
    returned in a's type, (B, S, W).
    """
    h = h0.float()
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t].float() * h + b[:, t].float()
        out[:, t] = h.to(a.dtype)
    return out


def rglru_scan_bwd_ref(g: torch.Tensor, a: torch.Tensor, h: torch.Tensor,
                       h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of ``rglru_scan_ref``: a reverse loop in float32.

    g = dL/dh and a, h (the forward's states): (B, S, W); h0: (B, W).
    With c_{S-1} = g_{S-1} and c_t = g_t + a_{t+1} c_{t+1}, returns
    (da, db, dh0) = (c_t h_{t-1}, c_t, a_0 c_0), h_{-1} = h0, in float32.
    """
    B, S, W = a.shape
    da = torch.empty(B, S, W, dtype=torch.float32, device=a.device)
    db = torch.empty_like(da)
    c = torch.zeros(B, W, dtype=torch.float32, device=a.device)
    a_next = torch.zeros_like(c)
    for t in range(S - 1, -1, -1):
        c = g[:, t].float() + a_next * c
        db[:, t] = c
        da[:, t] = c * (h[:, t - 1].float() if t else h0.float())
        a_next = a[:, t].float()
    return da, db, a_next * c
