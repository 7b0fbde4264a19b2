"""Plain PyTorch versions of the decode attention kernel: the function
(the port of ``repro/kernels/decode_attention/ref.py``) and the split-KV
arithmetic of ``csrc/decode_attention.cu`` (slices, partials, combine)."""

from __future__ import annotations

import torch

__all__ = ["TILE", "decode_attention_ref", "decode_attention_split_ref", "split_starts"]

NEG_INF = -2.0e38

# Cache slots per tile of the kernel (kBK in csrc/decode_attention.cu); the
# slices of the split pass are whole tiles.
TILE = 32


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


def split_starts(n_split: int, S: int) -> list[int]:
    """First cache slot of each of the kernel's ``n_split`` slices, then the
    end of the last: slice s holds tiles [s * n_tiles // n_split,
    (s + 1) * n_tiles // n_split) of ``TILE`` slots (the last one may reach
    past S)."""
    n_tiles = -(-S // TILE)
    return [s * n_tiles // n_split * TILE for s in range(n_split + 1)]


def decode_attention_split_ref(
    q: torch.Tensor,        # (B, H, D)
    k: torch.Tensor,        # (B, S, Hkv, D)
    v: torch.Tensor,        # (B, S, Hkv, D)
    lengths: torch.Tensor,  # (B,)
    n_split: int,
) -> torch.Tensor:
    """What the split and combine passes compute, in float32: per slice
    the running max m_s, sum l_s and unnormalised acc_s over its slots
    below the row's length (m_s = -inf, l_s = 0 for a slice with none),
    then o = sum_s e^{m_s - M} acc_s / max(sum_s e^{m_s - M} l_s, 1e-30)
    over the non-empty slices, the scale applied to the scores after the
    product. Equal to ``decode_attention_ref`` up to the order of sums."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    s = torch.einsum("bkgd,bskd->bkgs", q.float().reshape(B, Hkv, H // Hkv, D),
                     k.float()) * D ** -0.5
    pos = torch.arange(S, device=q.device)
    valid = pos[None, :] < lengths.to(q.device).clamp(0, S)[:, None]  # (B, S)
    starts = split_starts(n_split, S)
    ms, ls, accs = [], [], []
    for lo, hi in zip(starts[:-1], starts[1:]):
        mask = (valid & (pos >= lo) & (pos < hi))[:, None, None, :]
        m = torch.where(mask, s, torch.tensor(-torch.inf, device=q.device)).amax(-1)
        p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros((), device=q.device))
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgs,bskd->bkgd", p, v.float()))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)  # split first
    live = l > 0
    big = torch.where(live, m, torch.tensor(-torch.inf, device=q.device)).amax(0)
    w = torch.where(live, torch.exp(m - big), torch.zeros((), device=q.device))
    acc = torch.where(live[..., None], acc, torch.zeros((), device=q.device))
    num = (w[..., None] * acc).sum(0)
    out = num / (w * l).sum(0).clamp_min(1e-30)[..., None]
    return out.reshape(B, H, D).to(q.dtype)
