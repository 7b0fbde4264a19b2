"""Build a kernel's CUDA source with ``nvcc`` into a shared library and load it.

Every kernel of the port has a plain C entry point, so it builds in seconds
with ``nvcc`` alone (no PyTorch headers) and is bound with ``ctypes``. The
library goes into ``build/`` beside the kernel's package (listed in
``.gitignore``), at first use, from the sources in the checkout only; its
name carries a hash of the source and flags, so an edited source rebuilds.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_info", "load_library"]

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict[Path, ctypes.CDLL] = {}
_INFO: dict[Path, dict] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernel")
    return str(path)


def build_info(source: Path) -> dict:
    """The library path of ``source`` and, when this process built it, the
    build seconds and nvcc's output (ptxas register and spill report)."""
    with _LOCK:
        return _INFO.setdefault(source, {})


def _build(source: Path, flags: tuple[str, ...], info: dict) -> Path:
    tag = hashlib.sha1(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    build_dir = source.parent.parent / "build"
    lib_path = build_dir / f"lib{source.stem}_{tag}.so"
    if not lib_path.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        # Concurrent builders of one source race safely: each writes its own
        # temporary file and renames it into place.
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *flags, "-o", str(tmp), str(source)], capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
        info.update(seconds=time.perf_counter() - t0, log=proc.stdout + proc.stderr)
    info["library"] = str(lib_path)
    return lib_path


def load_library(source: Path, entry: str, argtypes: list,
                 flags: tuple[str, ...] = NVCC_FLAGS) -> ctypes.CDLL:
    """The library built from ``source`` with ``flags``, its ``entry``
    function bound to ``argtypes`` returning an ``int`` status. Built on the
    first call, then cached for the process."""
    lib = _LIBS.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(_build(source, flags, build_info(source))))
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        with _LOCK:
            lib = _LIBS.setdefault(source, lib)
    return lib
