"""Plain PyTorch versions of the flash attention kernel: the function (the
port of ``repro/kernels/flash_attention/ref.py``, in the model layout) and
a CPU emulation of the bf16 kernel's numerics."""

from __future__ import annotations

import torch

__all__ = ["flash_attention_bf16_emulation", "flash_attention_ref"]

NEG_INF = -2.0e38


def _mask(Sq: int, Sk: int, causal: bool, window: int, device) -> torch.Tensor:
    """(Sq, Sk) keys each query sees, queries right-aligned to the keys."""
    q_pos = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    k_pos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= k_pos > q_pos - window
    return mask


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
    mask = _mask(Sq, Sk, causal, window, q.device)
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def flash_attention_bf16_emulation(
    q: torch.Tensor,   # (B, Sq, H, D), bf16 values
    k: torch.Tensor,   # (B, Sk, Hkv, D)
    v: torch.Tensor,   # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    window: int = 0,
    split_p: bool = True,
) -> torch.Tensor:
    """The arithmetic of the bf16 kernel (``csrc/flash_attention.cu``,
    flash_attention_mma_kernel) on the CPU, in float32: bf16 q . k summed in
    float32 with the scale applied after the product, an online softmax over
    the kernel's key tiles (64 keys, 32 at head dim 256), and P.V as
    ``P_hi . V + P_lo . V`` with P_hi = bf16(P) and P_lo = bf16(P - P_hi);
    ``split_p=False`` rounds P to bf16 once instead. Output in bf16.
    """
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    bf = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    qg = bf(q).reshape(B, Sq, Hkv, H // Hkv, D)
    kf, vf = bf(k), bf(v)
    mask = _mask(Sq, Sk, causal, window, q.device)
    neg = torch.tensor(-1.0e30, device=q.device)
    m = torch.full((B, Hkv, H // Hkv, Sq), -1.0e30, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, Hkv, H // Hkv, Sq, D, device=q.device)
    bk = 32 if D >= 256 else 64
    for k0 in range(0, Sk, bk):
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kf[:, k0:k0 + bk]) * D ** -0.5
        seen = mask[:, k0:k0 + bk]
        s = torch.where(seen, s, neg)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.where(seen, torch.exp(s - m_new[..., None]), torch.zeros((), device=q.device))
        l = l * corr + p.sum(-1)
        p_hi = bf(p)
        pv = torch.einsum("bkgqs,bskd->bkgqd", p_hi, vf[:, k0:k0 + bk])
        if split_p:
            pv = pv + torch.einsum("bkgqs,bskd->bkgqd", bf(p - p_hi), vf[:, k0:k0 + bk])
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(torch.bfloat16)
