"""PyTorch + CUDA port of the scheduler reproduction (``repro``).

The package mirrors ``repro``'s layout (``repro_torch.core``,
``repro_torch.kernels.sched_scoring``) and imports neither JAX nor
``repro``. Host-side bookkeeping (graph building, ``ScheduleState``'s O(m)
deltas, exact ``Fraction`` stepping) stays NumPy, as in the reference;
everything batched (candidate sweeps, the simulator's fixed point) runs on
``torch`` tensors on an explicit device.

Everything numeric is float64, as the reference is under x64. Batched entry
points take ``device=`` and default to ``"cuda"``; without a card they
raise rather than fall back to the CPU (pass ``device="cpu"`` to run the
plain PyTorch versions).

``"meta"`` (shapes and types, no storage) is accepted only inside
``allow_meta()``, which the dry-run tooling (``launch.steps``' abstract
helpers, ``launch.dryrun``) opens; every other entry point refuses it.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["DTYPE", "allow_meta", "resolve_device"]

DTYPE = torch.float64

_META_OK = [False]


@contextlib.contextmanager
def allow_meta():
    """Within this block ``resolve_device`` accepts ``"meta"``."""
    before = _META_OK[0]
    _META_OK[0] = True
    try:
        yield
    finally:
        _META_OK[0] = before


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Validate a device request: ``"cpu"``, or ``"cuda"`` with a card present
    (``"meta"`` too inside ``allow_meta()``).

    Raises instead of silently running a ``"cuda"`` request on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch path"
            )
    elif dev.type != "cpu" and not (dev.type == "meta" and _META_OK[0]):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev
