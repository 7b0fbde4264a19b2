"""Wrapper of the RG-LRU scan kernel: checks, dispatch by device, launch
counts, and its gradient.

``rglru_scan(a, b, h0)`` returns every state of ``h_t = a_t * h_{t-1} +
b_t``, as ``repro.kernels.rglru_scan.ops.rglru_scan`` does. On CUDA
tensors it launches the hand-written kernel (``csrc/rglru_scan.cu``, the
port of ``repro/kernels/rglru_scan/kernel.py``'s Pallas kernel); on CPU
tensors it runs the plain PyTorch version (``ref.py``). There is no
fallback between the two: a launch that fails raises. On meta tensors (the
dry-run's, shapes without storage) both directions only make their
outputs' shapes; nothing is computed or counted.

Under grad mode, where an input requires grad, the call goes through
``_Scan``, a ``torch.autograd.Function`` whose backward is a reverse scan:
on CUDA tensors the hand-written ``rglru_scan_bwd`` kernel (in the same
source), on CPU tensors its plain version ``rglru_scan_bwd_ref``. It saves
``a``, the output ``h`` and ``h0``. The backward takes float32 ``a`` and
``b`` only (training computes them in float32) and refuses any other type
by name.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_ref, rglru_scan_ref

__all__ = ["LAUNCHES", "rglru_scan", "rglru_scan_bwd", "reset_launches"]

# Kernel launches since the last reset. Only a launch of a CUDA kernel
# counts; the CPU path and empty inputs launch nothing.
LAUNCHES = {"rglru_scan": 0, "rglru_scan_bwd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """(B, S, W) states of the linear recurrence over axis 1.

    a, b: contiguous (B, S, W) of one type, float32 or bfloat16; h0: (B, W),
    taken as float32. The carry is float32; the output is in a's type.
    Differentiable with respect to all three for float32 a and b.
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
    if a.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"rglru_scan runs on cpu, cuda or meta tensors, not {a.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (a, b, h0)):
        if a.dtype != torch.float32:
            raise TypeError(f"the rglru_scan backward takes float32 a and b, got {a.dtype}")
        return _Scan.apply(a, b, h0)
    return _forward(a, b, h0.to(torch.float32).contiguous())


def _forward(a, b, h0):
    """The scan on a's device; h0 float32 and contiguous."""
    if a.numel() == 0 or a.device.type == "meta":
        return torch.empty_like(a)
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    from repro_torch.kernels.rglru_scan.kernel import load_library

    B, S, W = a.shape
    out = torch.empty_like(a)
    err = load_library().rglru_scan_launch(
        _device_index(a), _DTYPES[a.dtype], a.data_ptr(), b.data_ptr(), h0.data_ptr(),
        out.data_ptr(), B, S, W, torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed with CUDA error {err}")
    LAUNCHES["rglru_scan"] += 1
    return out


def rglru_scan_bwd(g: torch.Tensor, a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor,
                   grad_h0: bool = True):
    """(da, db, dh0) of the scan, from g = dL/dh, a, the forward's states h
    (B, S, W) and h0 (B, W), all float32; dh0 is None unless ``grad_h0``.
    The kernel on CUDA tensors, the plain version on CPU tensors."""
    if g.shape != a.shape or h.shape != a.shape or a.ndim != 3:
        raise ValueError(f"expected g = a = h (B, S, W); got {tuple(g.shape)}, "
                         f"{tuple(a.shape)}, {tuple(h.shape)}")
    B, S, W = a.shape
    if tuple(h0.shape) != (B, W):
        raise ValueError(f"h0 must be ({B}, {W}), got {tuple(h0.shape)}")
    if any(t.dtype != torch.float32 for t in (g, a, h, h0)):
        raise TypeError("the rglru_scan backward takes float32 g, a, h and h0, got "
                        f"{g.dtype}, {a.dtype}, {h.dtype}, {h0.dtype}")
    if any(t.device != a.device for t in (g, h, h0)):
        raise ValueError("g, a, h, h0 must lie on one device")
    if a.device.type == "cpu":
        da, db, dh0 = rglru_scan_bwd_ref(g, a, h, h0)
        return da, db, dh0 if grad_h0 else None
    if a.device.type == "meta":
        return torch.empty_like(a), torch.empty_like(a), torch.empty_like(h0) if grad_h0 else None
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan_bwd runs on cpu, cuda or meta tensors, not {a.device}")
    g, a, h, h0 = (t.contiguous() for t in (g, a, h, h0))
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty_like(h0) if grad_h0 else None
    if a.numel() == 0:
        return da, db, dh0.zero_() if grad_h0 else None
    from repro_torch.kernels.rglru_scan.kernel import load_library

    err = load_library().rglru_scan_bwd_launch(
        _device_index(a), g.data_ptr(), a.data_ptr(), h.data_ptr(), h0.data_ptr(),
        da.data_ptr(), db.data_ptr(), dh0.data_ptr() if grad_h0 else None, B, S, W,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"rglru_scan_bwd kernel launch failed with CUDA error {err}")
    LAUNCHES["rglru_scan_bwd"] += 1
    return da, db, dh0


class _Scan(torch.autograd.Function):
    """The scan with its hand-written backward (float32 a and b)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h0f = h0.to(torch.float32).contiguous()
        h = _forward(a, b, h0f)
        ctx.save_for_backward(a, h, h0f)
        ctx.h0_dtype = h0.dtype
        return h

    @staticmethod
    def backward(ctx, g):
        a, h, h0 = ctx.saved_tensors
        need_a, need_b, need_h0 = ctx.needs_input_grad
        da, db, dh0 = rglru_scan_bwd(g.float(), a, h, h0, grad_h0=need_h0)
        return (da if need_a else None, db if need_b else None,
                dh0.to(ctx.h0_dtype) if need_h0 else None)
