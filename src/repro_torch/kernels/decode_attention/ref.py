"""Plain PyTorch version of the decode attention kernel (the port of
``repro/kernels/decode_attention/ref.py``)."""

from __future__ import annotations

import torch

__all__ = ["decode_attention_ref"]

NEG_INF = -2.0e38


def decode_attention_ref(
    q: torch.Tensor,        # (B, H, D) one query per batch row
    k: torch.Tensor,        # (B, S, Hkv, D)
    v: torch.Tensor,        # (B, S, Hkv, D)
    lengths: torch.Tensor,  # (B,) valid cache length per row
) -> torch.Tensor:
    """One-token GQA attention over the first ``lengths[b]`` cache slots of
    each row, float32 math; the G query heads of a KV head share it."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Hkv, H // Hkv, D) * D ** -0.5
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float())
    valid = torch.arange(S, device=q.device)[None, :] < lengths.to(q.device)[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return out.reshape(B, H, D).to(q.dtype)
