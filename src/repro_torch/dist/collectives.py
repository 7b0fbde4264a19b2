"""Collectives of the mesh route, with ``shard_map``'s gradients.

Code that runs on each rank's local shards (``local_map`` bodies: the MoE
block's expert parallelism, the vocabulary-sharded cross entropy) calls
these where the reference's ``shard_map`` bodies call ``lax.psum`` and
friends. Each goes through ``torch.distributed._functional_collectives``,
so the step analyser sees and counts it. Their gradients are the
transposes JAX gives under ``shard_map``:

* ``psum``: all-reduce; the result is the same on every rank, so its
  gradient passes through;
* ``pvary``: identity on a value that is the same on every rank, where
  the ranks' work on it differs; its gradient is all-reduced (the
  transpose of JAX's implicit ``pvary``);
* ``pmax``: all-reduce of the maximum, for values taken without gradient.

Axes of one rank are skipped: nothing is sent.
"""

from __future__ import annotations

import torch

__all__ = ["group", "pmax", "psum", "pvary"]


def group(mesh, axes):
    """The process group over ``axes`` of ``mesh`` (several: flattened, in
    mesh order, the first axis major, as JAX orders a multi-axis group)."""
    axes = tuple(a for a in mesh.mesh_dim_names if a in axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def _all_reduce(x: torch.Tensor, pg, op: str = "sum") -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol

    out = funcol.all_reduce(x.contiguous(), op, pg)
    return out.wait() if hasattr(out, "wait") else out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        return _all_reduce(x, pg)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.pg), None


def _busy(mesh, axes) -> tuple:
    names = mesh.mesh_dim_names
    return tuple(a for a in axes if mesh.size(names.index(a)) > 1)


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    axes = _busy(mesh, axes)
    return _Psum.apply(x, group(mesh, axes)) if axes else x


def pvary(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    axes = _busy(mesh, axes)
    return _Pvary.apply(x, group(mesh, axes)) if axes else x


def pmax(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    axes = _busy(mesh, axes)
    return _all_reduce(x.detach(), group(mesh, axes), "max") if axes else x.detach()
