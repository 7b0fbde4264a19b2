"""Build and load ``csrc/cut_traffic.cu`` (nvcc -> shared library -> ctypes).

Built by ``repro_torch.kernels._build`` into ``build/`` beside this file at
first use. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import _build

__all__ = ["NVCC_FLAGS", "SOURCE", "launch_plan", "load_library"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "cut_traffic.cu"

# -fmad=false: no multiply-add contraction, so every product and sum rounds
# once, as the plain version's do.
NVCC_FLAGS = _build.NVCC_FLAGS + ("-fmad=false",)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_ARGTYPES = [
    _I32,                   # device
    _P, _P, _I64,           # tm, comp, comp_stride
    _P, _I64,               # unit_ir, uir_stride
    _P, _P,                 # alpha, cir
    _P, _P, _P, _I32, _I32,  # send_slot, recv_slot, edges, n_edges, k2
    _P, ctypes.c_double,    # distance, penalty
    _P,                     # out
    _I64, _I64, _I32, _I32,  # B, T, n, m
    _P,                     # stream
]


def load_library() -> ctypes.CDLL:
    """The built kernel library (built on first call, then cached)."""
    return _build.load_library(SOURCE, "cut_traffic_launch", _ARGTYPES, NVCC_FLAGS)


_PLAN = ("rows", "threads", "smem_bytes", "layout", "tile_columns", "tile_stages", "blocks",
         "blocks_per_sm", "registers", "local_bytes")


def launch_plan(B: int, T: int, k2: int, m: int, device: int = 0) -> dict:
    """The launch ``cut_traffic_launch`` makes for B rows of T tasks, k2
    contracted slots and m machines: rows and threads a block, shared bytes,
    layout (0 X^T and Y^T in shared memory, 1 Y^T apart, 2 both in a global
    scratch), columns of a distance tile, tiles in flight, blocks, resident
    blocks a SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), and
    registers and local (spilled) bytes a thread."""
    lib = load_library()
    fn = lib.cut_traffic_plan
    fn.argtypes = [_I32, _I64, _I64, _I32, _I32, ctypes.POINTER(_I64)]
    fn.restype = ctypes.c_int
    out = (_I64 * len(_PLAN))()
    err = fn(device, B, T, k2, m, out)
    if err != 0:
        raise RuntimeError(f"cut_traffic_plan failed with CUDA error {err}")
    return dict(zip(_PLAN, out))
