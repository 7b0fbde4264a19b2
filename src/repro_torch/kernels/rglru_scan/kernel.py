"""Build and load ``csrc/rglru_scan.cu`` (nvcc -> shared library -> ctypes).

Built by ``repro_torch.kernels._build`` into ``build/`` beside this file at
first use. Nothing here runs at import time. The library holds two
entries: ``rglru_scan_launch`` (the forward) and ``rglru_scan_bwd_launch``
(its backward).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import _build

__all__ = ["SOURCE", "load_library"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu"

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_ARGTYPES = [
    _I32, _I32,               # device, dtype (0 float32, 1 bfloat16)
    _P, _P, _P, _P,           # a, b, h0, out
    _I64, _I64, _I64,         # B, S, W
    _P,                       # stream
]
_BWD_ARGTYPES = [
    _I32,                     # device
    _P, _P, _P, _P,           # g, a, h, h0 (float32)
    _P, _P, _P,               # da, db, dh0 (float32; dh0 may be null)
    _I64, _I64, _I64,         # B, S, W
    _P,                       # stream
]


def load_library() -> ctypes.CDLL:
    """The built kernel library (built on first call, then cached), both
    entries bound."""
    lib = _build.load_library(SOURCE, "rglru_scan_launch", _ARGTYPES)
    bwd = lib.rglru_scan_bwd_launch
    bwd.argtypes = _BWD_ARGTYPES
    bwd.restype = ctypes.c_int
    return lib
