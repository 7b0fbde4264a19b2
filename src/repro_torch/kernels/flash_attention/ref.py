"""Plain PyTorch version of the flash attention kernel (the port of
``repro/kernels/flash_attention/ref.py``, in the model layout)."""

from __future__ import annotations

import torch

__all__ = ["flash_attention_ref"]

NEG_INF = -2.0e38


def flash_attention_ref(
    q: torch.Tensor,   # (B, Sq, H, D)
    k: torch.Tensor,   # (B, Sk, Hkv, D)
    v: torch.Tensor,   # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """GQA attention with the full (Sq, Sk) score matrix, float32 math.

    Queries are right-aligned to the keys (``q_pos = i + Sk - Sq``); query
    head ``h`` reads key/value head ``h // (H // Hkv)``.
    """
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, Hkv, H // Hkv, D) * D ** -0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    q_pos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)
