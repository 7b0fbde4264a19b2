"""Build and load ``csrc/decode_attention.cu`` (nvcc -> shared library -> ctypes).

Built by ``repro_torch.kernels._build`` into ``build/`` beside this file at
first use. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import _build

__all__ = ["SOURCE", "load_library"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_ARGTYPES = [
    _I32, _I32,               # device, dtype (0 float32, 1 bfloat16)
    _P, _P, _P, _P, _P, _P,   # q, k, v, lengths, o, float32 scratch of the partials
    _I64, _I64,               # B, S
    _I32, _I32, _I32, _I32,   # H, Hkv, D, n_split
    ctypes.c_float, _P,       # scale, stream
]


def load_library() -> ctypes.CDLL:
    """The built kernel library (built on first call, then cached)."""
    return _build.load_library(SOURCE, "decode_attention_launch", _ARGTYPES)
