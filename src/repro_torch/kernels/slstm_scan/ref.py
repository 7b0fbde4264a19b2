"""Plain PyTorch version of the sLSTM recurrence kernel: the time loop of
``repro.models.xlstm.slstm_block``'s ``lax.scan``, as the port ran it in
``models/xlstm.py`` before the kernel."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["slstm_scan_ref"]


def slstm_scan_ref(zx, ix, fx, ox, rw, c, n, h, m):
    """The time loop. Gate inputs (B, S, d) float32, ``rw`` (d, d) float32,
    the state c, n, h, m (B, d) float32. Returns (h (B, S, d), c, n, h, m
    after the last step). Differentiable: the training route."""
    # Elementwise in the input alone, so computed for every step at once.
    log_f, o = F.logsigmoid(fx), torch.sigmoid(ox)
    hs = []
    for t in range(zx.shape[1]):
        zt = torch.tanh(zx[:, t] + h @ rw)
        m_new = torch.maximum(log_f[:, t] + m, ix[:, t])
        i_p = torch.exp(ix[:, t] - m_new)
        f_p = torch.exp(log_f[:, t] + m - m_new)
        c = f_p * c + i_p * zt
        n = f_p * n + i_p
        h = o[:, t] * c / n.clamp_min(1.0)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), c, n, h, m
