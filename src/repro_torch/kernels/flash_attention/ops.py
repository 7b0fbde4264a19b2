"""Wrapper of the flash attention kernel: checks, dispatch by device, launch count.

``flash_attention`` takes the model layout, q (B, Sq, H, D) and k, v
(B, Sk, Hkv, D), as ``repro.kernels.flash_attention.ops`` does. On CUDA
tensors it launches the hand-written kernel (``csrc/flash_attention.cu``,
the port of ``repro/kernels/flash_attention/kernel.py``'s Pallas kernel);
on CPU tensors it runs the plain PyTorch version (``ref.py``). There is no
fallback between the two: a launch that fails raises. The kernel has no
backward: on CUDA tensors that require grad (under grad mode) it raises
rather than return a result without a gradient.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["HEAD_DIMS", "LAUNCHES", "flash_attention", "reset_launches"]

# Kernel launches since the last reset. Only a launch of the CUDA kernel
# counts; the CPU path and empty inputs launch nothing.
LAUNCHES = {"flash_attention": 0}

# Head dims the kernel is built for; the plain version takes any.
HEAD_DIMS = (32, 64, 128, 256)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def _check_rows(name: str, x: torch.Tensor) -> None:
    """Dims after the batch dim contiguous, 16-byte aligned rows and batches."""
    _, _, heads, d = x.shape
    if x.stride(3) != 1 or x.stride(2) != d or x.stride(1) != heads * d:
        raise ValueError(f"{name} must be contiguous after its batch dim, strides {x.stride()}")
    if x.data_ptr() % 16 or (x.stride(0) * x.element_size()) % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def flash_attention(
    q: torch.Tensor,   # (B, Sq, H, D)
    k: torch.Tensor,   # (B, Sk, Hkv, D)
    v: torch.Tensor,   # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """(B, Sq, H, D) GQA attention, queries right-aligned to the keys.

    ``causal`` masks keys after the query's position, ``window`` > 0 keys
    at or before ``q_pos - window``. float32 or bfloat16 in, float32 math,
    output in the input type. k and v may be a prefix of a KV cache (a
    batch stride of their own).
    """
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, Sq, H, D), k = v (B, Sk, Hkv, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or H % Hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")
    if window < 0:
        raise ValueError("window must be >= 0")
    if causal and Sq > Sk:
        raise ValueError(f"causal attention needs Sq <= Sk (every query sees a key); got {Sq} > {Sk}")
    if B == 0 or Sq == 0:
        return torch.empty_like(q)
    if Sk == 0:
        raise ValueError("attention over zero keys")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, not {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("the flash_attention kernel has no backward, so its result would carry "
                           "no gradient: train through models.attention.sdpa, as model.loss_fn does")
    return _launch(q, k, v, causal, window)


def _launch(q, k, v, causal, window):
    from repro_torch.kernels.flash_attention.kernel import load_library

    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS}, got {D}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_rows(name, x)
    if k.stride(0) != v.stride(0):
        raise ValueError("k and v must share their batch stride")
    lib = load_library()
    out = torch.empty(B, Sq, H, D, dtype=q.dtype, device=q.device)
    err = lib.flash_attention_launch(
        q.device.index if q.device.index is not None else torch.cuda.current_device(),
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, Hkv, D, q.stride(0), k.stride(0), out.stride(0),
        D ** -0.5, int(causal), int(window),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return out
