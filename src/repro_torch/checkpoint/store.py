"""Sharded, atomic, async checkpointing of tensor trees.

The port of ``repro.checkpoint.store``, with its on-disk layout:
``<dir>/step_<N>/`` holding ``shard_0.npz`` (flat key -> array) plus
``manifest.json`` (tree structure, keys, step, time, ``extra``). Writes go
to ``step_<N>.tmp`` and are renamed into place only after the shard and
the fsynced manifest are written, so a preempted writer never corrupts the
latest checkpoint. Keys join the tree path's dict keys and ``#<index>``
list positions with ``::``, as the reference's ``_path_str`` does, so a
checkpoint of a plain tree written by either package restores in the
other. Types NumPy cannot hold (bfloat16, the float8 types) are stored as
their raw bits with a ``<key>::dtype`` entry naming the type.

The port's trees hold torch tensors; they go to NumPy on the host before
the write, and ``restore`` returns tensors of the like-tree's types on its
devices. ``AsyncCheckpointer`` moves serialization off the training
thread: ``save`` copies a snapshot to host memory and enqueues it; a
worker thread persists it. The queue (depth 1) applies back-pressure
instead of piling snapshots up in RAM.
"""

from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch._tree import leaves_with_path, unflatten

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer", "retain"]

_SEP = "::"
# Types stored as raw bits: the integer type of each width that carries them.
_BITS = {1: (np.uint8, torch.int8, np.int8), 2: (np.uint16, torch.int16, np.int16)}


def _path_str(p) -> str:
    return f"#{p}" if isinstance(p, int) else str(p)


def _host(leaf) -> tuple[np.ndarray, str | None]:
    """The leaf (a tensor, or anything ``np.asarray`` takes) as a host array,
    and the name of its type where NumPy cannot hold it (the array then
    holds the raw bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype.is_floating_point and t.dtype not in (torch.float16, torch.float32,
                                                         torch.float64):
            width = t.element_size()
            return t.view(_BITS[width][1]).numpy().view(_BITS[width][0]), str(t.dtype)[6:]
        return t.numpy(), None
    return np.asarray(leaf), None


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    flat = {}
    for path, leaf in leaves_with_path(tree):
        key = _SEP.join(_path_str(p) for p in path)
        arr, raw = _host(leaf)
        if raw is not None:
            flat[key + "::dtype"] = np.str_(raw)
        flat[key] = arr
    return flat


def _structure(tree: Any) -> str:
    """The tree with every leaf written ``*``."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(v)}" for k, v in sorted(tree.items())) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_structure(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def save(ckpt_dir: str | os.PathLike, step: int, tree: Any, extra: dict | None = None) -> Path:
    """Synchronous atomic save. Returns the final directory path."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    flat = _flatten(tree)
    np.savez(tmp / "shard_0.npz", **flat)
    manifest = {
        "step": step,
        "time": time.time(),
        "treedef": _structure(tree),
        "keys": sorted(flat.keys()),
        "extra": extra or {},
    }
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str | os.PathLike) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for d in ckpt_dir.iterdir():
        m = re.fullmatch(r"step_(\d+)", d.name)
        if m and (d / "manifest.json").exists():
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore(ckpt_dir: str | os.PathLike, tree_like: Any,
            step: int | None = None) -> tuple[Any, int]:
    """Restore into the structure of ``tree_like``. Returns (tree, step):
    each leaf a tensor of the like-leaf's type on its device."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    out = []
    with np.load(d / "shard_0.npz") as data:
        for path, like in leaves_with_path(tree_like):
            key = _SEP.join(_path_str(p) for p in path)
            arr = np.require(data[key], requirements=["W"])  # copies only a read-only array
            if key + "::dtype" in data:
                raw = getattr(torch, str(data[key + "::dtype"]))
                t = torch.from_numpy(arr.view(_BITS[arr.itemsize][2])).view(raw)
            else:
                t = torch.from_numpy(arr)
            like = like if isinstance(like, torch.Tensor) else torch.as_tensor(like)
            out.append(t.to(device=like.device, dtype=like.dtype))
    return unflatten(tree_like, out), step


def retain(ckpt_dir: str | os.PathLike, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` checkpoints."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return
    steps = sorted(
        int(m.group(1))
        for d in ckpt_dir.iterdir()
        if (m := re.fullmatch(r"step_(\d+)", d.name))
    )
    for s in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s:08d}", ignore_errors=True)


class AsyncCheckpointer:
    """Background checkpoint writer with bounded queue back-pressure."""

    def __init__(self, ckpt_dir: str | os.PathLike, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err: Exception | None = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            step, tree, extra = item
            try:
                save(self.ckpt_dir, step, tree, extra)
                retain(self.ckpt_dir, self.keep)
            except Exception as e:  # surfaced on next save()/close()
                self._err = e

    def save(self, step: int, tree: Any, extra: dict | None = None) -> None:
        if self._err:
            raise self._err
        # Snapshot to host memory before enqueueing: the next step may write
        # new tensors, and the worker must not read the card's.
        host_tree = unflatten(tree, [
            leaf.detach().to("cpu", copy=True) if isinstance(leaf, torch.Tensor)
            else np.array(leaf) for _, leaf in leaves_with_path(tree)])
        self._q.put((step, host_tree, extra))

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()
        if self._err:
            raise self._err
