"""Gradient compression for a cross-host all-reduce, on trees of tensors.

The port of ``repro.optim.compression``:

* ``to_bf16`` / ``from_f32`` cast a gradient tree to bfloat16 before the
  reduction and back to the parameters' types after it;
* ``quantize_ef`` / ``dequantize``: per-tensor symmetric int8 quantization
  with an error-feedback residual carried from step to step (1-bit-Adam
  style, at 8 bits): quantize(g + residual) is reduced, and what the
  rounding lost is fed back the next step.

As in the reference, ``launch.steps.make_train_step`` does not apply them:
they are pieces for a multi-host step.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch._tree import leaves, tree_map, unflatten

__all__ = ["to_bf16", "from_f32", "init_residual", "quantize_ef", "dequantize"]


def to_bf16(grads: Any) -> Any:
    return tree_map(lambda g: g.to(torch.bfloat16), grads)


def from_f32(grads: Any, like: Any) -> Any:
    return tree_map(lambda g, p: g.to(p.dtype), grads, like)


def init_residual(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


@torch.no_grad()
def quantize_ef(grads: Any, residual: Any) -> tuple[Any, Any, Any]:
    """int8 error-feedback quantization.

    Returns (int8 tree, float32 scale tree, new residual tree): per tensor
    q = round(g / s) clipped to [-127, 127], s = max|g + r| / 127 (at least
    1e-12 / 127), and the new residual g + r - q s.
    """

    def one(g, r):
        g32 = g.float() + r
        s = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g32 / s), -127, 127).to(torch.int8)
        return q, s, g32 - q.float() * s

    out = [one(g, r) for g, r in zip(leaves(grads), leaves(residual), strict=True)]
    return tuple(unflatten(grads, [o[i] for o in out]) for i in range(3))


def dequantize(q: Any, scales: Any) -> Any:
    return tree_map(lambda qq, s: qq.float() * s, q, scales)
