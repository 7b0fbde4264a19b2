"""Production and smoke meshes: the port of ``repro.launch.mesh``.

Functions, never module-level constants, so that importing this module
touches no process group. Each builds a ``DeviceMesh`` through
``init_device_mesh`` over the default process group, which the caller has
initialised with at least as many ranks as the mesh holds. A production
mesh holds 256 or 512 ranks: on one card it exists only over a fake
process group (``torch.distributed`` with the ``fake`` backend, one
process standing for every rank), which serves to build shardings and to
trace a step's collectives, not to run one.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import resolve_device

__all__ = ["make_production_mesh", "make_smoke_mesh"]


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = "cuda") -> DeviceMesh:
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks).

    Axes: ``data`` carries batch/FSDP, ``model`` carries TP/EP, ``pod``
    extends data parallelism hierarchically across pods.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(resolve_device(device).type, shape, mesh_dim_names=axes)


def make_smoke_mesh(data: int = 2, model: int = 2,
                    device: str | torch.device = "cuda") -> DeviceMesh:
    """A small ``("data", "model")`` mesh for integration tests."""
    return init_device_mesh(resolve_device(device).type, (data, model),
                            mesh_dim_names=("data", "model"))
