"""Build and load ``csrc/policy_scan.cu`` (nvcc -> shared library -> ctypes).

Built by ``repro_torch.kernels._build`` into ``build/`` beside this file at
first use. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import _build

__all__ = ["NVCC_FLAGS", "SOURCE", "load_library"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "policy_scan.cu"

# -fmad=false: no multiply-add contraction, so every product and sum rounds
# once, as the plain version's and the executor's do.
NVCC_FLAGS = _build.NVCC_FLAGS + ("-fmad=false",)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_F64 = ctypes.c_double
_ARGTYPES = [
    _I32,                       # device
    _P, _P,                     # rates, capacity
    _P, _P, _P,                 # tm, e, met
    _P, _P, _P,                 # order, mstart, comp
    _P, _P, _P,                 # alpha, topo, shares
    _P, _P, _P, _P, _P, _P,     # throughput, admitted, dropped, queue_total, throttle, util
    _I64, _I64,                 # B, P
    _I32, _I32, _I32, _I32, _I32, _I32, _I32,  # T, m, n, E, K, W, S
    _F64, _F64, _F64, _F64, _F64, _F64, _F64,  # dt, max_queue, bp_high, bp_low, down, up, min
    _I64,                       # shared-memory bytes of a block
    _P,                         # stream
]


def load_library() -> ctypes.CDLL:
    """The built kernel library (built on first call, then cached)."""
    return _build.load_library(SOURCE, "policy_scan_launch", _ARGTYPES, NVCC_FLAGS)
