"""Build and load ``csrc/slstm_scan.cu`` (nvcc -> shared library -> ctypes).

Built by ``repro_torch.kernels._build`` into ``build/`` beside this file at
first use. Nothing here runs at import time. The library holds five
entries: ``slstm_scan_launch`` (the kernel in the layout the caller names,
or with ``serial_floor`` set its serial floor), ``slstm_scan_bwd_launch``
(its backward, the same way; in the cluster layout its loop alone),
``slstm_scan_bwd_rest_launch`` (the cluster layout's rest of the backward,
after the loop), ``slstm_scan_plan`` (the cooperative layout's launch of a
shape, either direction) and ``slstm_scan_device`` (the device's attributes
that the cluster layout's plan reads).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import _build

__all__ = ["MAX_CLUSTER", "SOURCE", "device_attributes", "launch_plan", "load_library"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "slstm_scan.cu"

# The largest cluster the kernel launches (kMaxCluster in the source).
MAX_CLUSTER = 16

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_ARGTYPES = [
    _I32,                     # device
    _P, _P, _P, _P, _P,       # zx, ix, fx, ox, rw
    _P, _P, _P, _P,           # c0, n0, h0, m0
    _P, _P, _P, _P, _P,       # hs, c, n, h, m
    _P, _P, _P, _P,           # cs, ns, ms, zs: every step's c, n, m, z (all null: not saved)
    _I64, _I64, _I64,         # B, S, d
    _I32, _I32, _I32,         # layout (0 cooperative, 1 cluster), C, R
    _I32,                     # serial_floor
    _P,                       # stream
]
_BWD_ARGTYPES = [
    _I32,                     # device
    _P, _P, _P, _P, _P,       # dhs, dc, dn, dh, dm: the outputs' gradients (null: zero)
    _P, _P, _P, _P,           # ix, fx, ox, rw
    _P, _P, _P,               # c0, n0, m0
    _P, _P, _P, _P,           # cs, ns, ms, zs: the forward's saved steps
    _P, _P, _P, _P,           # dzx, dix, dfx, dox
    _P, _P, _P, _P,           # dc0, dn0, dh0, dm0
    _P,                       # gs: every step's dh_t (the cluster layout's loop writes it)
    _I64, _I64, _I64,         # B, S, d
    _I32, _I32, _I32,         # layout (0 cooperative, 1 cluster), C, R
    _I32,                     # serial_floor
    _P,                       # stream
]
_REST_ARGTYPES = [
    _I32,                     # device
    _P, _P, _P, _P,           # gs, dc, dn, dm: every step's dh_t, the final state's (null: zero)
    _P, _P, _P,               # ix, fx, ox
    _P, _P, _P,               # c0, n0, m0
    _P, _P, _P, _P,           # cs, ns, ms, zs
    _P, _P, _P,               # dix, dfx, dox
    _P, _P, _P,               # dc0, dn0, dm0
    _I64, _I64, _I64,         # B, S, d
    _P,                       # stream
]
_PLAN_KEYS = ("grid", "groups", "groups_per_block", "chunk", "rows", "rw_resident",
              "smem_bytes", "blocks_per_sm", "registers", "local_bytes")
_DEVICE_KEYS = ("sms", "smem_optin", "cooperative_launch", "cluster_launch", "registers",
                "local_bytes", "bwd_registers", "bwd_local_bytes", "rest_registers",
                "rest_local_bytes")


def load_library() -> ctypes.CDLL:
    """The built kernel library (built on first call, then cached), every
    entry bound."""
    lib = _build.load_library(SOURCE, "slstm_scan_launch", _ARGTYPES)
    bwd = lib.slstm_scan_bwd_launch
    bwd.argtypes = _BWD_ARGTYPES
    bwd.restype = ctypes.c_int
    rest = lib.slstm_scan_bwd_rest_launch
    rest.argtypes = _REST_ARGTYPES
    rest.restype = ctypes.c_int
    plan = lib.slstm_scan_plan
    plan.argtypes = [_I32, _I64, _I64, _I32, ctypes.POINTER(_I64)]
    plan.restype = ctypes.c_int
    device = lib.slstm_scan_device
    device.argtypes = [_I32, ctypes.POINTER(_I64)]
    device.restype = ctypes.c_int
    return lib


def launch_plan(B: int, d: int, device: int = 0, backward: bool = False) -> dict:
    """The cooperative layout's launch of a (B, d) call of the forward (or
    of the ``backward``): blocks (``grid``,
    all resident), column groups and groups a block, the k chunk and rows of
    h staged at once, whether ``rw``'s columns stay in shared memory, the
    dynamic shared bytes, resident blocks a SM, registers and local
    (spilled) bytes a thread."""
    out = (_I64 * len(_PLAN_KEYS))()
    err = load_library().slstm_scan_plan(device, B, d, int(backward), out)
    if err != 0:
        raise RuntimeError(f"slstm_scan_plan failed with CUDA error {err}")
    return dict(zip(_PLAN_KEYS, out))


def device_attributes(device: int = 0) -> dict:
    """The device's SMs and opt-in shared bytes a block, whether it takes
    cooperative and cluster launches, the forward cluster kernel's registers
    and local (spilled) bytes a thread, the backward cluster loop's
    (``bwd_``) and its rest kernel's (``rest_``), and
    ``active_clusters``: for C = 1 ..
    ``MAX_CLUSTER`` the clusters of C blocks it holds at once (0 where
    none)."""
    out = (_I64 * (len(_DEVICE_KEYS) + MAX_CLUSTER))()
    err = load_library().slstm_scan_device(device, out)
    if err != 0:
        raise RuntimeError(f"slstm_scan_device failed with CUDA error {err}")
    attrs = dict(zip(_DEVICE_KEYS, out))
    attrs["active_clusters"] = tuple(out[len(_DEVICE_KEYS):])
    return attrs
