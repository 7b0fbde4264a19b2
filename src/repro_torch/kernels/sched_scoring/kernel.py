"""Build and load ``csrc/sched_scoring.cu`` (nvcc -> shared library -> ctypes).

Built by ``repro_torch.kernels._build`` into ``build/`` beside this file at
first use. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import _build

__all__ = ["NVCC_FLAGS", "SOURCE", "load_library"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "sched_scoring.cu"

# -fmad=false: no multiply-add contraction anywhere, so every product and
# sum rounds exactly as NumPy's does (the kernel also spells its
# accumulation with round-to-nearest intrinsics).
NVCC_FLAGS = _build.NVCC_FLAGS + ("-fmad=false",)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_ARGTYPES = [
    _I32,                 # device
    _P, _P, _I64,         # tm, comp, comp_stride
    _P, _I64,             # unit_ir, uir_stride
    _P, _P,               # e_cm, met_cm
    _P, _I64,             # cap, cap_stride
    _P, _P, _P, _I64,     # net, mem_c, mem_cap, mem_cap_stride
    _P,                   # out
    _P, _I64,             # scratch, its bytes (ops.scratch_bytes)
    _I64, _I64, _I32,     # B, T, m
    _I32,                 # tile_w: machines a tile (m: the one-block layout; 0: the table)
    _I32,                 # slots: the table's slots (0 but for the table layout)
    _I32, _P,             # resources, stream
]


def load_library() -> ctypes.CDLL:
    """The built kernel library (built on first call, then cached)."""
    return _build.load_library(SOURCE, "sched_scoring_launch", _ARGTYPES, NVCC_FLAGS)
