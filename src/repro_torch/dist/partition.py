"""Path-based partition specs for params, batches and caches: the port of
``repro.dist.partition``.

Conventions follow ``launch.mesh``: ``data`` (plus optional ``pod``)
carries batch/FSDP, ``model`` carries tensor parallelism. The rules are the
reference's:

* a dimension is sharded only when its size divides the mesh axis, so every
  spec is valid on any mesh (replication is always a safe fallback);
* for parameters the *largest* ``model``-divisible dimension goes to
  ``model``, ties toward the trailing dimension; a path holding one of
  ``_REPLICATED_NAMES`` replicates, and so does a 1-D leaf under 4 096;
* batches and caches shard their leading dimension over ``("pod",
  "data")`` (the axes the mesh has); M-RoPE positions (3, B, S) shard
  dimension 1; a mesh with no data axis replicates them.

A spec is a ``Spec``: the tuple a ``PartitionSpec`` holds, one entry a
dimension, each ``None``, ``"model"`` or the tuple of data axes.
``shardings`` turns each into DTensor placements on a ``DeviceMesh``.

Layouts. The reference stacks each segment's repeats along a leading axis;
the port keeps one dict (one cache) a repeat, ``params["segments"][s][i][r]``
and ``caches[s][i][r]``. Both layouts are accepted: a leaf of a per-repeat
list is judged as the reference judges its stacked leaf (the path without
the repeat index, the shape with the repeat count in front), and its spec
is the stacked spec's without the leading entry. No parameter rule ever
places the stacked axis; the cache rule shards it over the data axes where
the repeat count divides them (``yi-9b``, ``starcoder2-7b`` and
``qwen2-vl-72b`` on 16 data ranks), which a per-repeat tensor has no
dimension for: its own dimensions then replicate, as in the reference. A
host value in a tree (a port cache's ``pos``) gets no spec (``None``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

__all__ = [
    "Sharding",
    "Spec",
    "batch_specs",
    "cache_specs",
    "mesh_axes",
    "param_specs",
    "shardings",
]

_TP_AXIS = "model"
_DATA_AXES = ("pod", "data")

# Path-name rules: parameters whose path contains one of these substrings
# replicate regardless of shape: small vectors whose all-gather cost
# outweighs any memory saving, or state that must be identical per shard.
_REPLICATED_NAMES = ("norm", "scale", "bias", "rope", "step", "count")


class Spec(tuple):
    """One entry a tensor dimension: ``None``, an axis name or a tuple of
    axis names (the contents of a ``PartitionSpec``)."""


class Sharding(NamedTuple):
    """A spec on a mesh: one DTensor placement a mesh dimension."""

    mesh: Any
    placements: tuple


def _axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` with named dimensions."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_axes(mesh, cfg: Any) -> tuple[tuple[str, ...], str]:
    """(data axes present in the mesh, tensor-parallel axis name).

    A mesh with no data axis (pure tensor parallelism) yields an empty
    tuple: batch dimensions then replicate, where naming an absent axis
    would be an error.
    """
    sizes = _axis_sizes(mesh)
    return tuple(a for a in _DATA_AXES if a in sizes), _TP_AXIS


def _param_spec(path: str, shape: tuple[int, ...], tp: int) -> Spec:
    replicated = Spec((None,) * len(shape))
    if tp <= 1 or not shape:
        return replicated
    lowered = path.lower()
    if any(s in lowered for s in _REPLICATED_NAMES):
        return replicated
    best, best_size = -1, 0
    for d in range(len(shape) - 1, -1, -1):
        if shape[d] % tp == 0 and shape[d] > best_size:
            best, best_size = d, shape[d]
    if best < 0 or (len(shape) == 1 and shape[0] < 4096):
        return replicated
    spec: list[Any] = [None] * len(shape)
    spec[best] = _TP_AXIS
    return Spec(spec)


def _batched_spec(shape: tuple[int, ...], data_axes: tuple[str, ...], dsize: int) -> Spec:
    if not data_axes or not shape or shape[0] % dsize != 0:
        return Spec((None,) * len(shape))
    return Spec((data_axes, *([None] * (len(shape) - 1))))


def _map(tree, assign: Callable, is_entry: Callable, path: tuple = (), reps: int | None = None):
    """``assign(path, shape, reps)`` at every tensor of ``tree``, in its
    structure. A list at a path where ``is_entry`` holds is a segment
    entry's repeats: its items keep the list's path and carry its length."""
    if isinstance(tree, torch.Tensor):
        return assign(path, tuple(tree.shape), reps)
    if isinstance(tree, dict):
        return {k: _map(v, assign, is_entry, path + (k,), reps) for k, v in tree.items()}
    if isinstance(tree, list) and reps is None and is_entry(path):
        return [_map(v, assign, is_entry, path, len(tree)) for v in tree]
    if isinstance(tree, (list, tuple)):
        out = [_map(v, assign, is_entry, path + (i,), reps) for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(getattr(tree, f.name), assign, is_entry, path + (f.name,), reps)
            for f in dataclasses.fields(tree) if f.init})
    return None  # None, or a host value: nothing to place


def _stacked(rule: Callable) -> Callable:
    """A rule on (path string, shape) lifted to ``_map``'s ``assign``: a
    per-repeat leaf is judged as its stacked leaf, then loses the stacked
    entry."""

    def assign(path, shape, reps):
        where = "/".join(str(k) for k in path)
        if reps is None:
            return rule(where, shape)
        return Spec(rule(where, (reps, *shape))[1:])

    return assign


def _data_size(mesh, data_axes) -> int:
    sizes = _axis_sizes(mesh)
    dsize = 1
    for a in data_axes:
        dsize *= int(sizes[a])
    return dsize


def param_specs(params: Any, mesh, cfg: Any) -> Any:
    """The ``Spec`` tree of ``params`` (path-name aware)."""
    tp = int(_axis_sizes(mesh).get(_TP_AXIS, 1))

    def is_entry(path):  # ("segments", s, i) or ("encoder", "segments", s, i)
        return (len(path) == 3 and path[0] == "segments") or (
            len(path) == 4 and path[:2] == ("encoder", "segments"))

    return _map(params, _stacked(lambda where, shape: _param_spec(where, shape, tp)), is_entry)


def batch_specs(batch: Any, mesh, cfg: Any) -> Any:
    """Shard the leading (batch) dimension over the data axes."""
    data_axes, _ = mesh_axes(mesh, cfg)
    dsize = _data_size(mesh, data_axes)

    def rule(where, shape):
        # M-RoPE positions are (3, B, S): the batch is dimension 1.
        if "mrope" in where and len(shape) == 3:
            if data_axes and shape[1] % dsize == 0:
                return Spec((None, data_axes, None))
            return Spec((None,) * 3)
        return _batched_spec(shape, data_axes, dsize)

    return _map(batch, _stacked(rule), lambda path: False)


def cache_specs(caches: Any, mesh, cfg: Any) -> Any:
    """KV/state caches are batch-major: shard dimension 0 over the data axes
    (of the stacked leaf, in the reference's layout)."""
    data_axes, _ = mesh_axes(mesh, cfg)
    dsize = _data_size(mesh, data_axes)
    return _map(caches, _stacked(lambda where, shape: _batched_spec(shape, data_axes, dsize)),
                lambda path: len(path) == 2)


def shardings(specs: Any, mesh) -> Any:
    """``Spec`` tree -> ``Sharding`` tree on a ``DeviceMesh``: for each mesh
    dimension, ``Shard(d)`` where tensor dimension d names its axis, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names

    def one(spec: Spec) -> Sharding:
        placements = []
        for name in names:
            dims = [d for d, entry in enumerate(spec)
                    if entry == name or (isinstance(entry, tuple) and name in entry)]
            placements.append(Shard(dims[0]) if dims else Replicate())
        return Sharding(mesh, tuple(placements))

    def walk(tree):
        if isinstance(tree, Spec):
            return one(tree)
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            out = [walk(v) for v in tree]
            return out if isinstance(tree, list) else tuple(out)
        if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
            return dataclasses.replace(tree, **{f.name: walk(getattr(tree, f.name))
                                                for f in dataclasses.fields(tree) if f.init})
        return tree

    return walk(specs)
