"""Wrapper of the decode attention kernel: checks, dispatch by device, launch count.

``decode_attention`` takes one query token per row, q (B, H, D), a KV
cache k, v (B, S, Hkv, D) and the valid length of each row, as
``repro.kernels.decode_attention.ops`` does. On CUDA tensors it launches
the hand-written kernel (``csrc/decode_attention.cu``, the port of
``repro/kernels/decode_attention/kernel.py``'s Pallas kernel: a split pass
over ``split_count`` slices of the cache and a combine pass); on CPU
tensors it runs the plain PyTorch version (``ref.py``). There is no
fallback between the two: a launch that fails raises. The kernel has no
backward: on CUDA tensors that require grad (under grad mode) it raises
rather than return a result without a gradient.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ref import TILE, decode_attention_ref

__all__ = ["HEAD_DIMS", "LAUNCHES", "decode_attention", "reset_launches", "split_count"]

# Kernel launches since the last reset. Only a launch of the CUDA kernel
# counts; the CPU path and empty inputs launch nothing.
LAUNCHES = {"decode_attention": 0}

# Head dims the kernel is built for; the plain version takes any.
HEAD_DIMS = (32, 64, 128, 256)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Streaming multiprocessors of an H100; the split pass aims at two blocks
# on each.
SMS = 132
# Largest share of the K/V bytes that the partials may add (written once
# and read once by the combine pass): about 15 %. At 0.16 recurrentgemma-2b's
# 2048-slot rings take 32 slices of exactly 2 tiles (15.7 %) rather than 30
# of 2 or 3 (14.8 %), so no block of the launch walks a third tile.
SCRATCH_SHARE = 0.16


def reset_launches() -> None:
    LAUNCHES["decode_attention"] = 0


def split_count(pairs: int, S: int, group: int, head_dim: int, elem_bytes: int) -> int:
    """Slices of the cache for the split pass over ``pairs`` = B * Hkv
    (batch row, KV head) pairs of ``S`` slots, ``group`` query heads each.

    From the shapes alone, never from the lengths (reading them would wait
    for the device): about two blocks per SM, fewer if the float32 partials
    (``group * (head_dim + 2)`` floats a slice) would pass
    ``SCRATCH_SHARE`` of the K/V bytes, but never fewer than one block per
    SM while there are tiles to cut; at least 1, at most the number of
    ``TILE``-slot tiles.
    """
    n_tiles = max(1, -(-S // TILE))
    fill = -(-SMS // pairs)
    want = -(-2 * SMS // pairs)
    cap = int(SCRATCH_SHARE * 2 * S * head_dim * elem_bytes // (group * (head_dim + 2) * 4))
    return max(1, min(n_tiles, max(fill, min(want, cap))))


def decode_attention(
    q: torch.Tensor,        # (B, H, D)
    k: torch.Tensor,        # (B, S, Hkv, D)
    v: torch.Tensor,        # (B, S, Hkv, D)
    lengths: torch.Tensor,  # (B,) int32
) -> torch.Tensor:
    """(B, H, D) attention of each row's query over its first ``lengths[b]``
    cache slots, 1 <= lengths[b] <= S. float32 or bfloat16 in, float32
    math, output in the input type.

    The lengths are checked on the CPU path; on the card they stay on the
    device (a check would wait for it) and the kernel clamps them to S.
    """
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, H, D), k = v (B, S, Hkv, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or H % Hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be ({B},) int32, got {tuple(lengths.shape)} {lengths.dtype}")
    if any(x.device != q.device for x in (k, v, lengths)):
        raise ValueError("q, k, v, lengths must lie on one device")
    if B == 0:
        return torch.empty_like(q)
    if q.device.type == "cpu":
        if bool(((lengths < 1) | (lengths > S)).any()):
            raise ValueError(f"lengths must lie in [1, {S}], got {lengths.tolist()}")
        return decode_attention_ref(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda tensors, not {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("the decode_attention kernel has no backward, so its result would carry "
                           "no gradient: train through models.attention.sdpa, as model.loss_fn does")
    return _launch(q, k, v, lengths)


def _launch(q, k, v, lengths):
    from repro_torch.kernels.decode_attention.kernel import load_library

    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS}, got {D}")
    for name, x in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    lib = load_library()
    n_split = split_count(B * Hkv, S, H // Hkv, D, q.element_size())
    out = torch.empty_like(q)
    part = torch.empty(B * Hkv * n_split * (H // Hkv) * (D + 2), dtype=torch.float32,
                       device=q.device)
    err = lib.decode_attention_launch(
        q.device.index if q.device.index is not None else torch.cuda.current_device(),
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), part.data_ptr(), B, S, H, Hkv, D, n_split, D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed with CUDA error {err}")
    LAUNCHES["decode_attention"] += 1
    return out
