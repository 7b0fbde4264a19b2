"""Step builders and abstract inputs: the port of ``repro.launch.steps``.

PyTorch runs eagerly, so a step is a plain closure over the config, the
device and, on the mesh route, a ``MeshCtx``:

* ``make_train_step``, ``make_serve_step`` and ``make_prefill_step`` take
  ``mesh=None`` as the reference's do. With a ``DeviceMesh`` the state,
  batch and caches they are handed are DTensors (placed by
  ``dist.partition``) and the model runs its mesh route
  (``models.model``'s docstring); ``mesh_opts`` carries the reference's
  distribution knobs, which the port's config does not hold
  (``mesh_ctx``).
* ``input_specs``, ``abstract_params``, ``abstract_train_state`` and
  ``abstract_caches`` are the reference's ``jax.eval_shape`` stand-ins:
  meta tensors (shapes and types, 0 bytes) with the reference's shapes and
  types, keyed as the runtime batch, in the port's per-repeat layout.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch import allow_meta, resolve_device
from repro_torch._tree import leaves, tree_map, unflatten
from repro_torch.dist import partition
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.layers import MeshCtx
from repro_torch.optim import adamw

__all__ = [
    "DIST_KNOBS",
    "abstract_caches",
    "abstract_params",
    "abstract_train_state",
    "input_specs",
    "make_prefill_step",
    "make_serve_step",
    "make_train_step",
    "mesh_ctx",
]

# The reference config's distribution knobs that the mesh route reads, and
# the ``MeshCtx`` field each sets.
DIST_KNOBS = {"sequence_parallel": "seq_sharded", "moe_ep_mode": "moe_ep_mode",
              "zero3_use_site_gather": "gather_weights"}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def mesh_ctx(mesh, cfg: ModelConfig, **knobs) -> MeshCtx:
    """The ``MeshCtx`` of ``mesh`` (``None``: no mesh): data and TP axes from
    ``dist.partition.mesh_axes``; ``knobs`` are ``DIST_KNOBS`` by the
    reference's names (``sequence_parallel``, ``moe_ep_mode``,
    ``zero3_use_site_gather``), each at the reference config's default
    where not given."""
    unknown = set(knobs) - set(DIST_KNOBS)
    if unknown:
        raise ValueError(f"unknown distribution knobs {sorted(unknown)}")
    if mesh is None:
        return MeshCtx(mesh=None)
    data_axes, tp = partition.mesh_axes(mesh, cfg)
    return MeshCtx(mesh=mesh, data_axes=data_axes, tp_axis=tp,
                   **{DIST_KNOBS[k]: v for k, v in knobs.items()})


# ---------------------------------------------------------------------------
# Abstract inputs / state
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Abstract batch for one cell, as meta tensors.

    train/prefill: the full sequence. decode: one new token and ``pos0``
    (the caches hold seq_len history: ``abstract_caches``).
    """
    B = shape.global_batch
    S = 1 if shape.is_decode else shape.seq_len
    act = _DTYPES[cfg.dtype]
    batch: dict[str, Any] = {}
    if cfg.embedding_inputs:
        batch["embeds"] = _meta((B, S, cfg.d_model), act)
    else:
        batch["tokens"] = _meta((B, S), torch.int32)
    if shape.kind == "train":
        batch["labels"] = _meta((B, S), torch.int32)
    if cfg.mrope_sections:
        batch["mrope_positions"] = _meta((3, B, S), torch.int32)
    if cfg.is_encoder_decoder:
        # decode consumes the encoder's output, which prefill computed
        key = "encoder_out" if shape.is_decode else "encoder_embeds"
        batch[key] = _meta((B, cfg.encoder_seq, cfg.d_model), act)
    if shape.is_decode:
        batch["pos0"] = _meta((), torch.int32)
    return batch


def abstract_params(cfg: ModelConfig) -> dict:
    """``init_params``' tree as meta tensors: built under a fake-tensor
    mode (nothing allocated), then handed over to the meta device."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = M.init_params(cfg, device="cpu")
    return tree_map(lambda t: _meta(t.shape, t.dtype), params)


def abstract_train_state(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig) -> dict:
    params = abstract_params(cfg)
    return {"params": params, "opt": adamw.init_opt_state(params, opt_cfg)}


def abstract_caches(cfg: ModelConfig, shape: ShapeConfig) -> list:
    """``init_caches`` at the cell's batch and sequence length, on meta."""
    with allow_meta():
        return M.init_caches(cfg, shape.global_batch, shape.seq_len, _DTYPES[cfg.dtype],
                             device="meta")


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    device: str | torch.device = "cuda", lr_fn: Callable | None = None,
                    remat: bool = False, mesh=None, mesh_opts: dict | None = None):
    """Returns train_step(state, batch) -> (state, metrics).

    ``state`` is ``{"params": ..., "opt": adamw.init_opt_state(...)}``; the
    step takes ``model.loss_fn`` (its training route: attention through
    ``sdpa``, ``remat`` as given), its gradients with respect to every
    parameter, then ``adamw.adamw_update`` (with ``lr_fn``, else the
    config's constant lr). Metrics: ``loss``, ``grad_norm`` and ``lr``, as
    0-d tensors on the device. The new state holds new tensors; the old
    state is not written. As in the reference, no gradient compression.
    ``mesh`` and ``mesh_opts``: the mesh route (module docstring).
    """
    ctx = mesh_ctx(mesh, cfg, **(mesh_opts or {}))

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        resolve_device(device)
        with ctx.scope():  # the backward meets plain tensors too
            params = tree_map(lambda p: p.detach().requires_grad_(True), state["params"])
            flat = leaves(params)
            loss = M.loss_fn(params, cfg, batch, device=device, remat=remat, ctx=ctx)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
            grads = unflatten(params, [torch.zeros_like(p) if g is None else g  # as jax.grad
                                       for g, p in zip(grads, flat)])
            new_params, new_opt, metrics = adamw.adamw_update(state["params"], grads,
                                                              state["opt"], opt_cfg, lr_fn)
        return {"params": new_params, "opt": new_opt}, dict(metrics, loss=loss.detach())

    return train_step


def make_serve_step(cfg: ModelConfig, kind: str = "decode", device: str | torch.device = "cuda",
                    mesh=None, mesh_opts: dict | None = None):
    """decode: one-token step against caches. prefill: fill caches from a
    full prompt. Returns serve_step(params, batch, caches) -> (logits, caches).
    ``mesh`` and ``mesh_opts``: the mesh route (module docstring).
    """
    ctx = mesh_ctx(mesh, cfg, **(mesh_opts or {}))
    if kind == "decode":
        def serve_step(params, batch, caches):
            return M.decode_step(params, cfg, batch, caches, device=device, ctx=ctx)
    elif kind == "prefill":
        def serve_step(params, batch, caches):
            return M.prefill(params, cfg, batch, caches, device=device, ctx=ctx)
    else:
        raise ValueError(f"kind must be 'decode' or 'prefill', got {kind!r}")
    return serve_step


def make_prefill_step(cfg: ModelConfig, device: str | torch.device = "cuda", mesh=None,
                      mesh_opts: dict | None = None):
    return make_serve_step(cfg, kind="prefill", device=device, mesh=mesh, mesh_opts=mesh_opts)
