"""Wrapper of the RG-LRU scan kernel: checks, dispatch by device, launch count.

``rglru_scan(a, b, h0)`` returns every state of ``h_t = a_t * h_{t-1} +
b_t``, as ``repro.kernels.rglru_scan.ops.rglru_scan`` does. On CUDA
tensors it launches the hand-written kernel (``csrc/rglru_scan.cu``, the
port of ``repro/kernels/rglru_scan/kernel.py``'s Pallas kernel); on CPU
tensors it runs the plain PyTorch version (``ref.py``). There is no
fallback between the two: a launch that fails raises. The kernel has no
backward: on CUDA tensors that require grad (under grad mode) it raises
rather than return a result without a gradient.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

__all__ = ["LAUNCHES", "rglru_scan", "reset_launches"]

# Kernel launches since the last reset. Only a launch of the CUDA kernel
# counts; the CPU path and empty inputs launch nothing.
LAUNCHES = {"rglru_scan": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    LAUNCHES["rglru_scan"] = 0


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """(B, S, W) states of the linear recurrence over axis 1.

    a, b: contiguous (B, S, W) of one type, float32 or bfloat16; h0: (B, W),
    taken as float32. The carry is float32; the output is in a's type.
    """
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"expected a = b (B, S, W); got {tuple(a.shape)}, {tuple(b.shape)}")
    B, S, W = a.shape
    if tuple(h0.shape) != (B, W):
        raise ValueError(f"h0 must be ({B}, {W}), got {tuple(h0.shape)}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"a and b must share float32 or bfloat16, got {a.dtype}, {b.dtype}")
    if not h0.is_floating_point():
        raise TypeError(f"h0 must be floating point, got {h0.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    if b.device != a.device or h0.device != a.device:
        raise ValueError("a, b, h0 must lie on one device")
    if a.numel() == 0:
        return torch.empty_like(a)
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cpu or cuda tensors, not {a.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (a, b, h0)):
        raise RuntimeError("the rglru_scan kernel has no backward, so its result would carry "
                           "no gradient: RG-LRU training on the card waits for ROADMAP A13b")
    return _launch(a, b, h0.to(torch.float32).contiguous())


def _launch(a, b, h0):
    from repro_torch.kernels.rglru_scan.kernel import load_library

    B, S, W = a.shape
    lib = load_library()
    out = torch.empty_like(a)
    err = lib.rglru_scan_launch(
        a.device.index if a.device.index is not None else torch.cuda.current_device(),
        _DTYPES[a.dtype], a.data_ptr(), b.data_ptr(), h0.data_ptr(), out.data_ptr(), B, S, W,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed with CUDA error {err}")
    LAUNCHES["rglru_scan"] += 1
    return out
