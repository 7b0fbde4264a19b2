"""Wrapper of the sLSTM recurrence kernel and its backward: checks, the
layout plan, dispatch by device, launch counts and the gradient.

``slstm_scan(zx, ix, fx, ox, rw, c, n, h, m)`` runs an sLSTM block's time
loop (``repro.models.xlstm.slstm_block``'s ``lax.scan``) and returns
``(hs, c, n, h, m)``: every step's output (B, S, d) and the state after
the last step. On CUDA tensors it launches the hand-written kernel
(``csrc/slstm_scan.cu``, one launch a call) in the layout ``plan`` names;
on CPU tensors it runs the plain PyTorch version (``ref.py``). There is no
fallback between the two or between the layouts: the layout is chosen
before the launch, and a launch that fails raises. On meta tensors it only
makes the outputs' shapes.

Under grad mode, where an input requires grad, the call goes through
``_SLSTMScan``, a ``torch.autograd.Function``: its forward also saves every
step's c, n, m and z, and its backward is ``slstm_scan_bwd``, on CUDA
tensors the hand-written backward (in the same source, in the layout
``plan`` names: in the cooperative layout one kernel, in the cluster layout
two, ``slstm_scan_bwd_chain``'s loop and then ``slstm_scan_bwd_rest``), on
CPU tensors its plain version ``ref.slstm_scan_bwd_ref``; then ``rw``'s
gradient is one float32 matrix product over the B S rows of the previous
outputs and dzx, at the caller's float32 matmul precision. On meta tensors
both only make shapes.

The layouts (the source's header says how each runs):

- ``"cluster"``: one thread-block cluster of C blocks a group of up to
  ``MAX_ROWS`` rows, block c holding ``rw[:, its columns]`` (the backward:
  ``rw[its rows, :]``) in registers, h (dz_pre) exchanged through
  distributed shared memory and waited for on an mbarrier of each block: no
  barrier across clusters (the backward: one pair of buffers and mbarriers
  a row, each row's exchange a phase of its own). It takes d up to
  ``MAX_CLUSTER_D`` (48 columns a block at most, C up to 16).
- ``"cooperative"``: one cooperative launch over the whole card, a grid
  barrier a step; every shape.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels.slstm_scan.kernel import MAX_CLUSTER
from repro_torch.kernels.slstm_scan.ref import (slstm_scan_bwd_chain_ref, slstm_scan_bwd_ref,
                                                 slstm_scan_bwd_rest_ref, slstm_scan_ref)

__all__ = ["CLUSTER_MIN_STEPS", "LAUNCHES", "LAYOUTS", "MAX_CLUSTER_D",
           "MAX_ROWS", "MAX_WIDTH", "Device", "bwd_serial_floor", "cluster_bwd_smem",
           "cluster_size", "cluster_smem", "column_split", "device", "plan", "reset_launches",
           "serial_floor", "slice_width", "slstm_scan", "slstm_scan_bwd", "slstm_scan_bwd_chain",
           "slstm_scan_bwd_rest"]

# Kernel launches since the last reset. Only a launch of a CUDA kernel
# counts; the CPU path, empty inputs and the serial floors launch nothing
# that counts. ``slstm_scan_bwd`` counts the backward's kernel in the
# cooperative layout and its loop in the cluster layout,
# ``slstm_scan_bwd_rest`` the cluster layout's rest kernel.
LAUNCHES = {"slstm_scan": 0, "slstm_scan_bwd": 0, "slstm_scan_bwd_rest": 0}

LAYOUTS = ("cluster", "cooperative")
_LAYOUT_IDS = {"cooperative": 0, "cluster": 1}

# The cluster kernel's shape (the constants of ``csrc/slstm_scan.cu``): 12
# warps of 4 columns each hold 48 columns of rw a block; a lane holds 24
# rows k of them, so k < 768; a lane updates one (row, column), so a
# cluster takes at most 8 rows (more rows take more clusters).
MAX_WIDTH = 48
MAX_CLUSTER_D = 768
MAX_ROWS = 8
# Calls of fewer steps take the cooperative layout where both fit. At (8, S,
# 768) on an H100 the cluster layout costs ~26 us to start (144 KiB of rw a
# block) and ~1.6 us a step, the cooperative one ~14 us and ~5.8 us a step:
# they cross near S = 3 (chip_smoke.py phase 16a' times both at S = 1 to 4
# and 512).
CLUSTER_MIN_STEPS = 3

_GATES = ("zx", "ix", "fx", "ox")
_STATE = ("c", "n", "h", "m")


@dataclass(frozen=True)
class Device:
    """What the plan reads of a device: the opt-in shared bytes a block, and
    ``active_clusters[C - 1]``: the clusters of C blocks of the cluster
    kernel it holds at once (0 where it holds none)."""
    smem_optin: int
    active_clusters: tuple[int, ...]


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def slice_width(d: int, C: int) -> int:
    """Columns a block of a cluster of C owns: ceil(d / C) rounded up to 4
    (every slice starts on a 16-byte boundary); the last block the rest."""
    return _ceil(_ceil(d, C), 4) * 4


def column_split(d: int, C: int) -> list[tuple[int, int]]:
    """(first column, width) of each block of a cluster of C: ``slice_width``
    columns each, the last block the rest (none where the others hold all)."""
    W = slice_width(d, C)
    return [(min(c * W, d), max(0, min(W, d - c * W))) for c in range(C)]


def cluster_size(d: int, largest: int = MAX_CLUSTER) -> int | None:
    """The fewest blocks a cluster can split d columns over (at most
    ``MAX_WIDTH`` a block, ``largest`` blocks), or None where no cluster of
    the kernel holds d."""
    if d > MAX_CLUSTER_D:
        return None
    C = _ceil(d, MAX_WIDTH)
    return C if C <= largest else None


def cluster_smem(R: int) -> int:
    """Dynamic shared bytes of a cluster block of R rows: two mbarriers (16
    bytes) and h double-buffered (2 R ``MAX_CLUSTER_D`` floats: every row
    padded to the kernel's widest)."""
    return 16 + 8 * R * MAX_CLUSTER_D


def cluster_bwd_smem(R: int) -> int:
    """Dynamic shared bytes of a backward cluster block of R rows: a pair of
    mbarriers a row (16 bytes) and dz_pre double-buffered a row (2 R
    ``MAX_CLUSTER_D`` floats)."""
    return 16 * R + 8 * R * MAX_CLUSTER_D


def _cannot(d: int, why: str) -> ValueError:
    return ValueError(f"the cluster layout cannot take d = {d}: {why}; the cooperative "
                      f"layout takes every shape")


def plan(B: int, S: int, d: int, dev: Device, layout: str | None = None) -> dict:
    """The launch of a (B, S, d) call on ``dev``: ``layout`` forced, or the
    cluster layout wherever it fits and the call has at least
    ``CLUSTER_MIN_STEPS`` steps, else the cooperative one. A forced layout
    that cannot take the shape raises, naming it.

    The cluster layout's plan: C blocks a cluster (the fewest that hold d),
    its ``columns`` (``column_split``), the device's ``active_clusters`` of
    C, R rows a cluster (as few as the resident clusters allow, at most
    ``MAX_ROWS`` and what shared memory holds, spread evenly over ``waves``
    of resident clusters), ``clusters`` = ceil(B / R), the rows of the last
    (``last_rows``) and the shared bytes a block; the backward's exchange
    runs one phase a row, each expecting one row's ``phase_bytes`` (4 d) from
    the cluster's blocks, in ``bwd_smem_bytes`` a block."""
    if layout is not None and layout not in LAYOUTS:
        raise ValueError(f"unknown slstm_scan layout {layout!r}: one of {LAYOUTS}")
    C = cluster_size(d, len(dev.active_clusters))
    why = None
    if C is None:
        why = (f"a block holds at most {MAX_WIDTH} columns of rw over k < {MAX_CLUSTER_D}, "
               f"a cluster at most {len(dev.active_clusters)} blocks")
    elif dev.active_clusters[C - 1] < 1:
        why = f"the device holds no cluster of {C} blocks"
    elif cluster_smem(1) > dev.smem_optin:
        why = f"one row needs more than the device's {dev.smem_optin} shared bytes a block"
    if layout is None:
        layout = "cluster" if why is None and S >= CLUSTER_MIN_STEPS else "cooperative"
    if layout == "cooperative":
        return {"layout": "cooperative"}
    if why is not None:
        raise _cannot(d, why)
    active = dev.active_clusters[C - 1]
    r_max = min(MAX_ROWS, (dev.smem_optin - 16) // (cluster_smem(1) - 16))
    waves = _ceil(_ceil(B, r_max), active)
    R = _ceil(B, waves * active)
    clusters = _ceil(B, R)
    return {"layout": "cluster", "C": C, "R": R, "clusters": clusters, "waves": waves,
            "last_rows": B - (clusters - 1) * R, "active_clusters": active,
            "width": slice_width(d, C), "columns": column_split(d, C),
            "smem_bytes": cluster_smem(R), "phase_bytes": 4 * d,
            "bwd_smem_bytes": cluster_bwd_smem(R)}


@functools.lru_cache(maxsize=None)
def _device(index: int) -> Device:
    from repro_torch.kernels.slstm_scan.kernel import device_attributes

    attrs = device_attributes(index)
    return Device(attrs["smem_optin"], attrs["active_clusters"])


def device(index: int | None = None) -> Device:
    """The plan's attributes of CUDA device ``index`` (the current one by
    default), read once a process."""
    return _device(torch.cuda.current_device() if index is None else index)


def _check(zx, ix, fx, ox, rw, c, n, h, m) -> None:
    named = dict(zip(_GATES + ("rw",) + _STATE, (zx, ix, fx, ox, rw, c, n, h, m)))
    if zx.ndim != 3:
        raise ValueError(f"zx must be (B, S, d), got {tuple(zx.shape)}")
    B, _, d = zx.shape
    for name in _GATES[1:]:
        if named[name].shape != zx.shape:
            raise ValueError(f"{name} must be {tuple(zx.shape)} as zx, got "
                             f"{tuple(named[name].shape)}")
    if tuple(rw.shape) != (d, d):
        raise ValueError(f"rw must be ({d}, {d}), got {tuple(rw.shape)}")
    for name in _STATE:
        if tuple(named[name].shape) != (B, d):
            raise ValueError(f"{name} must be ({B}, {d}), got {tuple(named[name].shape)}")
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"slstm_scan takes float32 tensors; {name} is {t.dtype}")
        if t.device != zx.device:
            raise ValueError(f"{name} lies on {t.device}, zx on {zx.device}: one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if zx.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"slstm_scan runs on cpu, cuda or meta tensors, not {zx.device}")


def _check_layout(layout: str | None, d: int) -> None:
    """A forced layout's refusals that hold on every device."""
    if layout is not None and layout not in LAYOUTS:
        raise ValueError(f"unknown slstm_scan layout {layout!r}: one of {LAYOUTS}")
    if layout == "cluster" and cluster_size(d) is None:
        raise _cannot(d, f"a block holds at most {MAX_WIDTH} columns of rw over k < "
                         f"{MAX_CLUSTER_D}, a cluster at most {MAX_CLUSTER} blocks")


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _launch(zx, ix, fx, ox, rw, c, n, h, m, layout: str | None, floor: bool,
            save: bool = False):
    from repro_torch.kernels.slstm_scan.kernel import load_library

    B, S, d = zx.shape
    index = _device_index(zx)
    p = plan(B, S, d, device(index), layout)
    hs = torch.empty_like(zx)
    out = [torch.empty_like(c) for _ in range(4)]
    saved = [torch.empty_like(zx) for _ in range(4)] if save else [None] * 4
    err = load_library().slstm_scan_launch(
        index, *(t.data_ptr() for t in (zx, ix, fx, ox, rw, c, n, h, m)),
        hs.data_ptr(), *(t.data_ptr() for t in out), *(_ptr(t) for t in saved), B, S, d,
        _LAYOUT_IDS[p["layout"]], p.get("C", 0), p.get("R", 0), int(floor),
        torch.cuda.current_stream(zx.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"slstm_scan kernel launch ({p['layout']} layout) failed with CUDA "
                           f"error {err}")
    return (hs, *out, *saved) if save else (hs, *out)


def _forward(zx, ix, fx, ox, rw, c, n, h, m, layout: str | None, save: bool):
    """The time loop on zx's device, checked: (hs, c, n, h, m) and, with
    ``save``, every step's c, n, m, z."""
    if zx.device.type == "meta":
        return (torch.empty_like(zx), *(torch.empty_like(t) for t in (c, n, h, m)),
                *(torch.empty_like(zx) for _ in range(4 * save)))
    if zx.device.type == "cpu":
        return slstm_scan_ref(zx, ix, fx, ox, rw, c, n, h, m, save=save)
    if zx.numel() == 0:  # no step, no row or no feature: nothing to launch
        return (torch.empty_like(zx), *(t.clone() for t in (c, n, h, m)),
                *(torch.empty_like(zx) for _ in range(4 * save)))
    out = _launch(zx, ix, fx, ox, rw, c, n, h, m, layout, floor=False, save=save)
    LAUNCHES["slstm_scan"] += 1
    return out


def slstm_scan(zx: torch.Tensor, ix: torch.Tensor, fx: torch.Tensor, ox: torch.Tensor,
               rw: torch.Tensor, c: torch.Tensor, n: torch.Tensor, h: torch.Tensor,
               m: torch.Tensor, layout: str | None = None):
    """(hs (B, S, d), c, n, h, m (B, d)) of the sLSTM time loop.

    zx, ix, fx, ox: the gate pre-activations (B, S, d); rw: the recurrent
    matrix (d, d); c, n, h, m: the entering state (B, d). All float32,
    contiguous, on one device. ``layout`` forces the kernel's layout (one of
    ``LAYOUTS``; ``plan`` chooses by default); a layout that cannot take the
    shape raises on every device. Differentiable with respect to every
    input (``_SLSTMScan``).
    """
    _check(zx, ix, fx, ox, rw, c, n, h, m)
    _check_layout(layout, zx.shape[2])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (zx, ix, fx, ox, rw, c, n, h, m)):
        return _SLSTMScan.apply(zx, ix, fx, ox, rw, c, n, h, m, layout)
    return _forward(zx, ix, fx, ox, rw, c, n, h, m, layout, save=False)


def serial_floor(zx, ix, fx, ox, rw, c, n, h, m, layout: str | None = None) -> None:
    """The kernel's serial floor on these CUDA inputs in ``layout`` (the
    plan's by default): the same launch with the arithmetic removed, its
    S - 1 barriers alone (grid-wide in the cooperative layout; a cluster's,
    with the h exchange, in the cluster layout). Timed beside the kernel;
    not counted as a launch of it."""
    _check(zx, ix, fx, ox, rw, c, n, h, m)
    _check_layout(layout, zx.shape[2])
    if zx.device.type != "cuda":
        raise ValueError(f"the serial floor runs on CUDA tensors, not {zx.device}")
    if zx.numel():
        _launch(zx, ix, fx, ox, rw, c, n, h, m, layout, floor=True)


_GRADS = ("dhs", "dc", "dn", "dh", "dm")
_SAVED = ("cs", "ns", "ms", "zs")


def _check_bwd(grads, ix, fx, ox, rw, c0, n0, m0, saved) -> None:
    if ix.ndim != 3:
        raise ValueError(f"ix must be (B, S, d), got {tuple(ix.shape)}")
    B, _, d = ix.shape
    steps = {"ix": ix, "fx": fx, "ox": ox, **dict(zip(_SAVED, saved)), "dhs": grads[0]}
    state = {"c0": c0, "n0": n0, "m0": m0, **dict(zip(_GRADS[1:], grads[1:]))}
    named = {**steps, "rw": rw, **state}
    for name, t in named.items():
        if t is None:
            continue
        want = (tuple(ix.shape) if name in steps else (d, d) if name == "rw" else (B, d))
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"slstm_scan_bwd takes float32 tensors; {name} is {t.dtype}")
        if t.device != ix.device:
            raise ValueError(f"{name} lies on {t.device}, ix on {ix.device}: one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ix.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"slstm_scan_bwd runs on cpu, cuda or meta tensors, not {ix.device}")


def _bwd_plan(ix, layout: str | None) -> dict:
    B, S, d = ix.shape
    return plan(B, S, d, device(_device_index(ix)), layout)


def _launch_chain(grads, ix, fx, ox, rw, c0, n0, m0, saved, p: dict, floor: bool):
    """The backward's kernel in ``p``'s layout (the cooperative layout's
    whole backward, or the cluster layout's loop, which also fills every
    step's dh_t): (dzx, dix, dfx, dox, dc0, dn0, dh0, dm0, dh_all), the
    cluster layout's dix, dfx, dox, dc0, dn0 and dm0 still empty and the
    cooperative layout's dh_all None."""
    from repro_torch.kernels.slstm_scan.kernel import load_library

    B, S, d = ix.shape
    gates = [torch.empty_like(ix) for _ in range(4)]
    state = [torch.empty_like(c0) for _ in range(4)]
    dh_all = torch.empty_like(ix) if p["layout"] == "cluster" and not floor else None
    err = load_library().slstm_scan_bwd_launch(
        _device_index(ix), *(_ptr(t) for t in grads),
        *(t.data_ptr() for t in (ix, fx, ox, rw, c0, n0, m0, *saved)),
        *(t.data_ptr() for t in gates + state), _ptr(dh_all), B, S, d, _LAYOUT_IDS[p["layout"]],
        p.get("C", 0), p.get("R", 0), int(floor), torch.cuda.current_stream(ix.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"slstm_scan_bwd kernel launch ({p['layout']} layout) failed with "
                           f"CUDA error {err}")
    return (*gates, *state, dh_all)


def _launch_rest(dh_all, dc, dn, dm, ix, fx, ox, c0, n0, m0, cs, ns, ms, zs, out=None):
    """The cluster layout's rest kernel: (dix, dfx, dox, dc0, dn0, dm0),
    into ``out`` where given."""
    from repro_torch.kernels.slstm_scan.kernel import load_library

    B, S, d = ix.shape
    if out is None:
        out = [torch.empty_like(ix) for _ in range(3)] + [torch.empty_like(c0) for _ in range(3)]
    err = load_library().slstm_scan_bwd_rest_launch(
        _device_index(ix), dh_all.data_ptr(), *(_ptr(t) for t in (dc, dn, dm)),
        *(t.data_ptr() for t in (ix, fx, ox, c0, n0, m0, cs, ns, ms, zs, *out)), B, S, d,
        torch.cuda.current_stream(ix.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"slstm_scan_bwd_rest kernel launch failed with CUDA error {err}")
    LAUNCHES["slstm_scan_bwd_rest"] += 1
    return tuple(out)


def slstm_scan_bwd(dhs, dc, dn, dh, dm, ix, fx, ox, rw, c0, n0, m0, cs, ns, ms, zs,
                   layout: str | None = None):
    """The time loop's backward but for ``rw``'s gradient: (dzx, dix, dfx,
    dox (B, S, d), dc0, dn0, dh0, dm0 (B, d)); dzx is the gradient of z's
    pre-activation, dz_pre.

    dhs (B, S, d) and dc, dn, dh, dm (B, d): the gradients of the outputs
    hs and the state after the last step, each None for zero; ix, fx, ox
    (B, S, d), rw (d, d), the entering state c0, n0, m0 (B, d) and the
    forward's saved c, n, m, z of every step (``slstm_scan_ref(...,
    save=True)``'s last four). All float32, contiguous, on one device. On
    CUDA tensors the kernels in ``layout`` (``plan``'s by default): one
    launch in the cooperative layout; in the cluster layout the loop
    (``slstm_scan_bwd_chain``) and then the rest (``slstm_scan_bwd_rest``),
    each counted. On CPU tensors ``ref.slstm_scan_bwd_ref``, on meta
    tensors shapes only.
    """
    grads, saved = (dhs, dc, dn, dh, dm), (cs, ns, ms, zs)
    _check_bwd(grads, ix, fx, ox, rw, c0, n0, m0, saved)
    _check_layout(layout, ix.shape[2])
    if ix.device.type == "meta":
        return (*(torch.empty_like(ix) for _ in range(4)), *(torch.empty_like(c0) for _ in range(4)))
    if ix.device.type == "cpu":
        return slstm_scan_bwd_ref(*grads, ix, fx, ox, rw, c0, n0, m0, *saved)
    if ix.numel() == 0:  # no step: the entering state's gradients are the final state's
        return (*(torch.empty_like(ix) for _ in range(4)),
                *(torch.zeros_like(c0) if g is None else g.clone() for g in grads[1:]))
    p = _bwd_plan(ix, layout)
    *out, dh_all = _launch_chain(grads, ix, fx, ox, rw, c0, n0, m0, saved, p, floor=False)
    LAUNCHES["slstm_scan_bwd"] += 1
    if dh_all is not None:
        _launch_rest(dh_all, dc, dn, dm, ix, fx, ox, c0, n0, m0, *saved,
                     out=out[1:4] + [out[4], out[5], out[7]])
    return tuple(out)


def slstm_scan_bwd_chain(dhs, dc, dn, dh, dm, ix, fx, ox, rw, c0, n0, m0, cs, ns, ms, zs):
    """The backward's serial part, ``slstm_scan_bwd``'s arguments: (dzx,
    dh_all, dh0), dz_pre and dh_t of every step (B, S, d) and the entering
    h's gradient (B, d). On CUDA tensors the cluster layout's loop kernel
    (one launch, counted as ``slstm_scan_bwd``; a d the layout cannot take
    raises by name), on CPU tensors ``ref.slstm_scan_bwd_chain_ref``."""
    grads, saved = (dhs, dc, dn, dh, dm), (cs, ns, ms, zs)
    _check_bwd(grads, ix, fx, ox, rw, c0, n0, m0, saved)
    _check_layout("cluster", ix.shape[2])
    if ix.device.type != "cuda":
        return slstm_scan_bwd_chain_ref(*grads, ix, fx, ox, rw, c0, n0, m0, *saved)
    if ix.numel() == 0:
        return (torch.empty_like(ix), torch.empty_like(ix),
                torch.zeros_like(c0) if dh is None else dh.clone())
    out = _launch_chain(grads, ix, fx, ox, rw, c0, n0, m0, saved, _bwd_plan(ix, "cluster"),
                        floor=False)
    LAUNCHES["slstm_scan_bwd"] += 1
    return out[0], out[8], out[6]


def slstm_scan_bwd_rest(dh_all, dc, dn, dm, ix, fx, ox, c0, n0, m0, cs, ns, ms, zs):
    """The backward's rest from every step's dh_t (``slstm_scan_bwd_chain``'s
    second output): (dix, dfx, dox (B, S, d), dc0, dn0, dm0 (B, d)). dc,
    dn, dm: the final state's gradients, each None for zero. On CUDA
    tensors the rest kernel (one launch, counted as ``slstm_scan_bwd_rest``),
    on CPU tensors ``ref.slstm_scan_bwd_rest_ref``."""
    _check_bwd((dh_all, dc, dn, None, dm), ix, fx, ox, None, c0, n0, m0, (cs, ns, ms, zs))
    if ix.device.type != "cuda":
        return slstm_scan_bwd_rest_ref(dh_all, dc, dn, dm, ix, fx, ox, c0, n0, m0, cs, ns, ms, zs)
    if ix.numel() == 0:
        return (*(torch.empty_like(ix) for _ in range(3)),
                *(torch.zeros_like(c0) if g is None else g.clone() for g in (dc, dn, dm)))
    return _launch_rest(dh_all, dc, dn, dm, ix, fx, ox, c0, n0, m0, cs, ns, ms, zs)


def bwd_serial_floor(dhs, dc, dn, dh, dm, ix, fx, ox, rw, c0, n0, m0, cs, ns, ms, zs,
                     layout: str | None = None) -> None:
    """The backward kernel's serial floor on these CUDA inputs in
    ``layout`` (the plan's by default): the same launch with the arithmetic
    removed, its S barriers (cooperative) or its loop's dz_pre exchange,
    phased by row, alone (cluster). Timed beside the kernel; not counted as
    a launch of it."""
    grads, saved = (dhs, dc, dn, dh, dm), (cs, ns, ms, zs)
    _check_bwd(grads, ix, fx, ox, rw, c0, n0, m0, saved)
    _check_layout(layout, ix.shape[2])
    if ix.device.type != "cuda":
        raise ValueError(f"the serial floor runs on CUDA tensors, not {ix.device}")
    if ix.numel():
        _launch_chain(grads, ix, fx, ox, rw, c0, n0, m0, saved, _bwd_plan(ix, layout), floor=True)


class _SLSTMScan(torch.autograd.Function):
    """The time loop with its hand-written backward. The forward saves every
    step's c, n, m, z beside its inputs and hs; an output's gradient that
    autograd does not pass (None) counts as zero."""

    @staticmethod
    def forward(ctx, zx, ix, fx, ox, rw, c, n, h, m, layout):
        hs, c_out, n_out, h_out, m_out, *saved = _forward(zx, ix, fx, ox, rw, c, n, h, m, layout,
                                                          save=True)
        ctx.save_for_backward(ix, fx, ox, rw, c, n, h, m, hs, *saved)
        ctx.layout = layout
        ctx.set_materialize_grads(False)
        return hs, c_out, n_out, h_out, m_out

    @staticmethod
    def backward(ctx, dhs, dc, dn, dh, dm):
        ix, fx, ox, rw, c0, n0, h0, m0, hs, *saved = ctx.saved_tensors
        grads = (None if g is None else g.contiguous() for g in (dhs, dc, dn, dh, dm))
        dzx, dix, dfx, dox, dc0, dn0, dh0, dm0 = slstm_scan_bwd(*grads, ix, fx, ox, rw, c0, n0,
                                                                 m0, *saved, layout=ctx.layout)
        need = ctx.needs_input_grad
        drw = None
        if need[4]:
            # sum over rows and steps of h_{t-1}^T dz_pre,t: h_{-1} is the
            # entering h, then every step's output but the last.
            B, S, d = ix.shape
            prev = torch.cat([h0[:, None], hs[:, :-1]], dim=1)
            drw = prev.reshape(B * S, d).t() @ dzx.reshape(B * S, d)
        out = (dzx, dix, dfx, dox, drw, dc0, dn0, dh0, dm0)
        return (*(g if need[i] else None for i, g in enumerate(out)), None)
