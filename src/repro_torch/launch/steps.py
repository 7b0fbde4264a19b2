"""Step builders: the port of ``repro.launch.steps``' ``make_train_step``,
``make_serve_step`` and ``make_prefill_step``.

PyTorch runs eagerly, so a step is a plain closure over the config and the
device. ``input_specs`` and the ``abstract_*`` helpers are ``jax.eval_shape``
dry-run tooling (ROADMAP A15).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch._tree import leaves, tree_map, unflatten
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw

__all__ = ["make_prefill_step", "make_serve_step", "make_train_step"]


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    device: str | torch.device = "cuda", lr_fn: Callable | None = None,
                    remat: bool = False):
    """Returns train_step(state, batch) -> (state, metrics).

    ``state`` is ``{"params": ..., "opt": adamw.init_opt_state(...)}``; the
    step takes ``model.loss_fn`` (its training route: attention through
    ``sdpa``, ``remat`` as given), its gradients with respect to every
    parameter, then ``adamw.adamw_update`` (with ``lr_fn``, else the
    config's constant lr). Metrics: ``loss``, ``grad_norm`` and ``lr``, as
    0-d tensors on the device. The new state holds new tensors; the old
    state is not written. As in the reference, no gradient compression.
    """

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        resolve_device(device)
        params = tree_map(lambda p: p.detach().requires_grad_(True), state["params"])
        flat = leaves(params)
        loss = M.loss_fn(params, cfg, batch, device=device, remat=remat)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = unflatten(params, [torch.zeros_like(p) if g is None else g  # as jax.grad
                                   for g, p in zip(grads, flat)])
        new_params, new_opt, metrics = adamw.adamw_update(state["params"], grads, state["opt"],
                                                          opt_cfg, lr_fn)
        return {"params": new_params, "opt": new_opt}, dict(metrics, loss=loss.detach())

    return train_step


def make_serve_step(cfg: ModelConfig, kind: str = "decode", device: str | torch.device = "cuda"):
    """decode: one-token step against caches. prefill: fill caches from a
    full prompt. Returns serve_step(params, batch, caches) -> (logits, caches).
    """
    if kind == "decode":
        def serve_step(params, batch, caches):
            return M.decode_step(params, cfg, batch, caches, device=device)
    elif kind == "prefill":
        def serve_step(params, batch, caches):
            return M.prefill(params, cfg, batch, caches, device=device)
    else:
        raise ValueError(f"kind must be 'decode' or 'prefill', got {kind!r}")
    return serve_step


def make_prefill_step(cfg: ModelConfig, device: str | torch.device = "cuda"):
    return make_serve_step(cfg, kind="prefill", device=device)
