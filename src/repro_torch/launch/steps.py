"""Serve-step builders: the port of ``repro.launch.steps``' ``make_serve_step``
and ``make_prefill_step``.

PyTorch runs eagerly, so a step is a plain closure over the config and the
device. ``input_specs`` and the ``abstract_*`` helpers are ``jax.eval_shape``
dry-run tooling and the train step needs the optimizer (ROADMAP A13, A15).
"""

from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

__all__ = ["make_prefill_step", "make_serve_step"]


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
