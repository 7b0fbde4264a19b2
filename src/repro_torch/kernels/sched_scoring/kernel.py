"""Build and load ``csrc/sched_scoring.cu`` (nvcc -> shared library -> ctypes).

The source has a plain C entry point, so it builds in seconds with ``nvcc``
alone (no PyTorch headers) into ``build/`` beside this file (listed in
``.gitignore``), at first use, from the sources in the checkout only. The
library name carries a hash of the source and flags, so an edited source
rebuilds. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BUILD_INFO", "NVCC_FLAGS", "SOURCE", "load_library"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "sched_scoring.cu"
BUILD_DIR = Path(__file__).resolve().parent / "build"

# -fmad=false: no multiply-add contraction anywhere, so every product and
# sum rounds exactly as NumPy's does (the kernel also spells its
# accumulation with round-to-nearest intrinsics).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

# Filled by the first successful build in this process: library path,
# build seconds and nvcc's output (ptxas register and spill report).
BUILD_INFO: dict = {}

_LIB: ctypes.CDLL | None = None

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
    _I64, _I64, _I32,     # B, T, m
    _I32, _P,             # resources, stream
]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernel")
    return str(path)


def load_library() -> ctypes.CDLL:
    """The built kernel library (built on first call, then cached)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    tag = hashlib.sha1(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib_path = BUILD_DIR / f"libsched_scoring_{tag}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)  # atomic: concurrent builders race safely
        BUILD_INFO.update(
            seconds=time.perf_counter() - t0, log=proc.stdout + proc.stderr
        )
    BUILD_INFO["library"] = str(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.sched_scoring_launch.argtypes = _ARGTYPES
    lib.sched_scoring_launch.restype = ctypes.c_int
    _LIB = lib
    return lib
