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
    _P, _P, _I32, _I32,     # list_of, list_slots, n_lists, n2
    _P, ctypes.c_double,    # distance, penalty
    _P,                     # out
    _I64, _I64, _I32, _I32,  # B, T, n, m
    _P, _I64, _I64,         # scratch, scratch_bytes, wave_rows
    _P,                     # stream
]


def load_library() -> ctypes.CDLL:
    """The built kernel library (built on first call, then cached)."""
    return _build.load_library(SOURCE, "cut_traffic_launch", _ARGTYPES, NVCC_FLAGS)


_PLAN = ("rows", "threads", "smem_bytes", "layout", "tile_columns", "tile_stages", "blocks",
         "blocks_per_sm", "registers", "local_bytes", "w_tile", "wave_rows", "scratch_bytes",
         "list_capacity")


def launch_plan(B: int, T: int, edges, m: int, device: int = 0) -> dict:
    """The launch ``cut_traffic_launch`` makes for B rows of T tasks of the
    topology ``edges`` on m machines: rows a block (layout 2: rows a group,
    the rows that share each list), threads a block, shared bytes, layout (0
    X^T and Y^T in shared memory, 1 Y^T apart, 2 the lists: X and Y in the
    wrapper's scratch, step 3 over each group's listed columns), columns of
    a distance tile, tiles in flight, blocks (layout 2: product blocks of a
    full wave), resident blocks a SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), registers and local
    (spilled) bytes a thread (layout 2: of the product kernel, step 3),
    machines w a distance tile, and in layout 2 the rows a wave, the
    scratch bytes (the kernel's count, which the wrapper's
    ``ops.list_wave`` allocates) and the columns a list can hold."""
    from repro_torch.kernels.cut_traffic import ops

    edges = tuple((int(a), int(b)) for a, b in edges)
    n = 1 + max((max(e) for e in edges), default=0)
    _, list_slots, n2 = ops.contracted_lists(edges, n)
    k2 = len({a for a, _ in edges}) + len({b for _, b in edges})
    wave_rows, _ = ops.list_wave(B, k2, m, len(list_slots))
    lib = load_library()
    fn = lib.cut_traffic_plan
    fn.argtypes = [_I32, _I64, _I64, _I32, _I32, _I32, _I32, _I64, ctypes.POINTER(_I64)]
    fn.restype = ctypes.c_int
    out = (_I64 * len(_PLAN))()
    err = fn(device, B, T, k2, m, len(list_slots), n2, wave_rows, out)
    if err != 0:
        raise RuntimeError(f"cut_traffic_plan failed with CUDA error {err}")
    return dict(zip(_PLAN, out))
