"""Build and load ``csrc/slstm_scan.cu`` (nvcc -> shared library -> ctypes).

Built by ``repro_torch.kernels._build`` into ``build/`` beside this file at
first use. Nothing here runs at import time. The library holds two
entries: ``slstm_scan_launch`` (the kernel, or with ``serial_floor`` set
its serial floor) and ``slstm_scan_plan`` (the launch a shape gets).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import _build

__all__ = ["SOURCE", "launch_plan", "load_library"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "slstm_scan.cu"

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_ARGTYPES = [
    _I32,                     # device
    _P, _P, _P, _P, _P,       # zx, ix, fx, ox, rw
    _P, _P, _P, _P,           # c0, n0, h0, m0
    _P, _P, _P, _P, _P,       # hs, c, n, h, m
    _I64, _I64, _I64,         # B, S, d
    _I32,                     # serial_floor
    _P,                       # stream
]
_PLAN_KEYS = ("grid", "groups", "groups_per_block", "chunk", "rows", "rw_resident",
              "smem_bytes", "blocks_per_sm", "registers", "local_bytes")


def load_library() -> ctypes.CDLL:
    """The built kernel library (built on first call, then cached), both
    entries bound."""
    lib = _build.load_library(SOURCE, "slstm_scan_launch", _ARGTYPES)
    plan = lib.slstm_scan_plan
    plan.argtypes = [_I32, _I64, _I64, ctypes.POINTER(_I64)]
    plan.restype = ctypes.c_int
    return lib


def launch_plan(B: int, d: int, device: int = 0) -> dict:
    """The launch of a (B, d) call: blocks (``grid``, all resident), column
    groups and groups a block, the k chunk and rows of h staged at once,
    whether ``rw``'s columns stay in shared memory, the dynamic shared
    bytes, resident blocks a SM, registers and local (spilled) bytes a
    thread."""
    out = (_I64 * len(_PLAN_KEYS))()
    err = load_library().slstm_scan_plan(device, B, d, out)
    if err != 0:
        raise RuntimeError(f"slstm_scan_plan failed with CUDA error {err}")
    return dict(zip(_PLAN_KEYS, out))
