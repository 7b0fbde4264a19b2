"""AdamW with global-norm clipping and a cosine schedule, on trees of tensors.

The port of ``repro.optim.adamw``: the same state (``m`` and ``v`` trees
in ``state_dtype`` beside the parameters, an int32 ``step``), the same
arithmetic, leaf by leaf in ``jax.tree``'s order (dict keys sorted), so
the global norm sums the squared float32 leaves in the reference's order.
Every function runs under ``torch.no_grad()`` and returns new tensors; it
writes none of its inputs. ``torch.optim.AdamW`` is not used: it applies
the weight decay before the moment step, clips nothing and keeps its
moments in the parameters' type.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch._tree import leaves, tree_map, unflatten

__all__ = [
    "AdamWConfig",
    "init_opt_state",
    "adamw_update",
    "cosine_schedule",
    "global_norm",
    "clip_by_global_norm",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"


@torch.no_grad()
def init_opt_state(params: Any, cfg: AdamWConfig) -> dict:
    """Zero moments in ``cfg.state_dtype`` on each parameter's device, step 0."""
    dt = _DTYPES[cfg.state_dtype]
    first = leaves(params)[0]
    # zeros_like: a DTensor parameter's moments keep its placements
    return {
        "m": tree_map(lambda p: torch.zeros_like(p, dtype=dt), params),
        "v": tree_map(lambda p: torch.zeros_like(p, dtype=dt), params),
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def _f32(ts: list) -> list:
    """float32 copies of the tensors that are not float32 already; a call
    made for a float32 one would be a no-op that still costs host time."""
    return [t if t.dtype == torch.float32 else t.float() for t in ts]


def _norm32(g32: list) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.stack([sq.sum() for sq in torch._foreach_mul(g32, g32)])))


def _clip32(flat: list, max_norm: float) -> tuple[list, list, torch.Tensor]:
    """(the scaled float32 leaves, the same rounded once through each leaf's
    type, the norm before): ``clip_by_global_norm``'s arithmetic."""
    g32 = _f32(flat)
    norm = _norm32(g32)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    scaled = torch._foreach_mul(g32, scale)
    typed = [s if g.dtype == torch.float32 else s.to(g.dtype) for s, g in zip(scaled, flat)]
    return scaled, typed, norm


@torch.no_grad()
def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum, in leaf order, of each float32 leaf's sum of squares."""
    return _norm32(_f32(leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """The tree scaled (in float32, back to each leaf's type) to a global norm
    of at most ``max_norm``; and the norm before."""
    _scaled, typed, norm = _clip32(leaves(grads), max_norm)
    return unflatten(grads, typed), norm


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1) -> Callable[[torch.Tensor], torch.Tensor]:
    """lr(step): linear warm-up to ``base_lr``, then a cosine down to
    ``min_ratio * base_lr`` at ``total_steps``; float32 arithmetic."""

    def lr(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)

    return lr


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: dict, cfg: AdamWConfig,
                 lr_fn: Callable | None = None) -> tuple[Any, dict, dict]:
    """One AdamW step. Returns (new params, new state, {"grad_norm", "lr"}).

    The gradients are clipped to ``cfg.clip_norm`` first; each parameter is
    taken to float32, moved by ``lr * (mhat / (sqrt(vhat) + eps) + wd * p)``
    and written back in its own type; m and v are kept in
    ``cfg.state_dtype``.
    """
    scaled, typed, gnorm = _clip32(leaves(grads), cfg.clip_norm)
    # The clipped gradients as the reference holds them: in their own type.
    g32 = [s if s is t else t.float() for s, t in zip(scaled, typed)]
    del scaled, typed
    step = state["step"] + 1
    lr = (lr_fn(step) if lr_fn is not None
          else torch.tensor(cfg.lr, dtype=torch.float32, device=step.device))
    sdt = _DTYPES[cfg.state_dtype]
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=step.device),
                          step.float())
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=step.device),
                          step.float())

    # Each line one multi-tensor op over every leaf (``torch._foreach_*``,
    # torch.optim's idiom): the reference's per-leaf arithmetic, rounded at
    # the same places, in a few launches instead of ~20 a leaf.
    flat_p = leaves(params)
    m32 = torch._foreach_mul(_f32(leaves(state["m"])), cfg.b1)
    torch._foreach_add_(m32, torch._foreach_mul(g32, 1 - cfg.b1))
    v32 = torch._foreach_mul(_f32(leaves(state["v"])), cfg.b2)
    torch._foreach_add_(v32, torch._foreach_mul(torch._foreach_mul(g32, g32), 1 - cfg.b2))
    del g32
    denom = torch._foreach_div(v32, b2c)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    delta = torch._foreach_div(m32, b1c)
    torch._foreach_div_(delta, denom)
    del denom
    p32 = _f32(flat_p)
    torch._foreach_add_(delta, torch._foreach_mul(p32, cfg.weight_decay))
    torch._foreach_mul_(delta, lr)
    new_p32 = torch._foreach_sub(p32, delta)
    del delta, p32
    new_params = unflatten(params, [q if q.dtype == p.dtype else q.to(p.dtype)
                                    for q, p in zip(new_p32, flat_p, strict=True)])
    new_state = {"m": unflatten(params, m32 if sdt == torch.float32 else [m.to(sdt) for m in m32]),
                 "v": unflatten(params, v32 if sdt == torch.float32 else [v.to(sdt) for v in v32]),
                 "step": step}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
