"""Plain PyTorch version of the RG-LRU scan kernel (the port of
``repro/kernels/rglru_scan/ref.py``)."""

from __future__ import annotations

import torch

__all__ = ["rglru_scan_ref"]


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
