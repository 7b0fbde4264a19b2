"""Wrapper of the sLSTM recurrence kernel: checks, dispatch by device and
launch counts.

``slstm_scan(zx, ix, fx, ox, rw, c, n, h, m)`` runs an sLSTM block's time
loop (``repro.models.xlstm.slstm_block``'s ``lax.scan``) and returns
``(hs, c, n, h, m)``: every step's output (B, S, d) and the state after
the last step. On CUDA tensors it launches the hand-written kernel
(``csrc/slstm_scan.cu``, one launch a call); on CPU tensors it runs the
plain PyTorch version (``ref.py``). There is no fallback between the two:
a launch that fails raises. On meta tensors it only makes the outputs'
shapes. The kernel has no backward: on CUDA tensors that require grad
under grad mode it raises, and the training route runs the plain loop
(``models.xlstm.slstm_block(train=True)``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref

__all__ = ["LAUNCHES", "reset_launches", "serial_floor", "slstm_scan"]

# Kernel launches since the last reset. Only a launch of the CUDA kernel
# counts; the CPU path, empty inputs and the serial floor launch nothing
# that counts.
LAUNCHES = {"slstm_scan": 0}

_GATES = ("zx", "ix", "fx", "ox")
_STATE = ("c", "n", "h", "m")


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _check(zx, ix, fx, ox, rw, c, n, h, m) -> None:
    named = dict(zip(_GATES + ("rw",) + _STATE, (zx, ix, fx, ox, rw, c, n, h, m)))
    if zx.ndim != 3:
        raise ValueError(f"zx must be (B, S, d), got {tuple(zx.shape)}")
    B, _, d = zx.shape
    for name in _GATES[1:]:
        if named[name].shape != zx.shape:
            raise ValueError(f"{name} must be {tuple(zx.shape)} as zx, got "
                             f"{tuple(named[name].shape)}")
    if tuple(rw.shape) != (d, d):
        raise ValueError(f"rw must be ({d}, {d}), got {tuple(rw.shape)}")
    for name in _STATE:
        if tuple(named[name].shape) != (B, d):
            raise ValueError(f"{name} must be ({B}, {d}), got {tuple(named[name].shape)}")
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"slstm_scan takes float32 tensors; {name} is {t.dtype}")
        if t.device != zx.device:
            raise ValueError(f"{name} lies on {t.device}, zx on {zx.device}: one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if zx.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"slstm_scan runs on cpu, cuda or meta tensors, not {zx.device}")


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _launch(zx, ix, fx, ox, rw, c, n, h, m, floor: bool):
    from repro_torch.kernels.slstm_scan.kernel import load_library

    B, S, d = zx.shape
    hs = torch.empty_like(zx)
    out = [torch.empty_like(c) for _ in range(4)]
    err = load_library().slstm_scan_launch(
        _device_index(zx), *(t.data_ptr() for t in (zx, ix, fx, ox, rw, c, n, h, m)),
        hs.data_ptr(), *(t.data_ptr() for t in out), B, S, d, int(floor),
        torch.cuda.current_stream(zx.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"slstm_scan kernel launch failed with CUDA error {err}")
    return hs, *out


def slstm_scan(zx: torch.Tensor, ix: torch.Tensor, fx: torch.Tensor, ox: torch.Tensor,
               rw: torch.Tensor, c: torch.Tensor, n: torch.Tensor, h: torch.Tensor,
               m: torch.Tensor):
    """(hs (B, S, d), c, n, h, m (B, d)) of the sLSTM time loop.

    zx, ix, fx, ox: the gate pre-activations (B, S, d); rw: the recurrent
    matrix (d, d); c, n, h, m: the entering state (B, d). All float32,
    contiguous, on one device.
    """
    _check(zx, ix, fx, ox, rw, c, n, h, m)
    if zx.device.type == "meta":
        return torch.empty_like(zx), *(torch.empty_like(t) for t in (c, n, h, m))
    if zx.device.type == "cpu":
        return slstm_scan_ref(zx, ix, fx, ox, rw, c, n, h, m)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (zx, ix, fx, ox, rw, c, n, h, m)):
        raise RuntimeError("the slstm_scan kernel has no backward: a CUDA input requires grad; "
                           "training runs the plain loop (slstm_block(train=True))")
    if zx.numel() == 0:  # no step, no row or no feature: nothing to launch
        return torch.empty_like(zx), *(t.clone() for t in (c, n, h, m))
    hs, *state = _launch(zx, ix, fx, ox, rw, c, n, h, m, floor=False)
    LAUNCHES["slstm_scan"] += 1
    return hs, *state


def serial_floor(zx, ix, fx, ox, rw, c, n, h, m) -> None:
    """The kernel's serial floor on these CUDA inputs: the same launch with
    the arithmetic removed, its S - 1 grid-wide barriers alone (timed beside
    the kernel; not counted as a launch of it)."""
    _check(zx, ix, fx, ox, rw, c, n, h, m)
    if zx.device.type != "cuda":
        raise ValueError(f"the serial floor runs on CUDA tensors, not {zx.device}")
    if zx.numel():
        _launch(zx, ix, fx, ox, rw, c, n, h, m, floor=True)
