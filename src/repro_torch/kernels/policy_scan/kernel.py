"""Build and load ``csrc/policy_scan.cu`` (nvcc -> shared library -> ctypes).

Built by ``repro_torch.kernels._build`` into ``build/`` beside this file at
first use. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import _build

__all__ = ["NVCC_FLAGS", "SOURCE", "load_library", "occupancy"]

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
    _P, _P,                     # e, met
    _P, _P, _P,                 # order, mstart, comp
    _P, _P, _P,                 # alpha, topo, shares
    _P, _P, _P, _P, _P, _P,     # throughput, admitted, dropped, queue_total, throttle, util
    _I64, _I64,                 # B, P
    _I32, _I32, _I32, _I32, _I32, _I32, _I32,  # T, m, n, E, K, W, S
    _I32,                       # pairs a block
    _F64, _F64, _F64, _F64, _F64, _F64, _F64,  # dt, max_queue, bp_high, bp_low, down, up, min
    _I64,                       # shared-memory bytes of a block
    _P,                         # stream
]


def load_library() -> ctypes.CDLL:
    """The built kernel library (built on first call, then cached)."""
    return _build.load_library(SOURCE, "policy_scan_launch", _ARGTYPES, NVCC_FLAGS)


def occupancy(B: int, P: int, pairs: int, smem_bytes: int, device: int = 0) -> dict:
    """The launch for B traces x P placements with ``pairs`` pairs a block
    and ``smem_bytes`` of shared memory: threads a block, resident blocks a
    SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), registers and
    local (spilled) bytes a thread, and blocks."""
    lib = load_library()
    fn = lib.policy_scan_occupancy
    fn.argtypes = [_I32, _I64, _I64, _I32, _I64, ctypes.POINTER(_I64)]
    fn.restype = ctypes.c_int
    out = (_I64 * 5)()
    err = fn(device, B, P, pairs, smem_bytes, out)
    if err != 0:
        raise RuntimeError(f"policy_scan_occupancy failed with CUDA error {err}")
    return dict(zip(("threads", "blocks_per_sm", "registers", "local_bytes", "blocks"), out))
