"""RG-LRU recurrent block (RecurrentGemma / Griffin): the port of
``repro.models.rglru``.

Block layout (Griffin "recurrent block"):

    x ->  W_in_gate -> GeLU ------------------\\
    x ->  W_in      -> causal conv1d -> RG-LRU -> (*) -> W_out

RG-LRU recurrence (diagonal, elementwise over the lru width):

    r_t = sigmoid(W_a u_t + b_a)              (recurrence gate)
    i_t = sigmoid(W_x u_t + b_x)              (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)    (decay, c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Prefill runs the recurrence through ``ops.rglru_scan`` (the hand-written
B5 kernel on the card, its plain sequential version on the CPU), where the
JAX package evaluates it with ``jax.lax.associative_scan``: the two agree
to float tolerance, not bit for bit. Training differentiates the scan
through ``ops.rglru_scan``'s backward (a reverse scan: the hand-written
kernel on the card), where the JAX package differentiates the associative
scan. Decode (one token) is the same
elementwise update as in the JAX package. The casts are the JAX package's:
gate products in the activation type, ``r``, ``i``, ``a``, ``b`` and the
carry in float32, the states cast back before ``* gate``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MeshCtx, dense, per_shard, init_dense

__all__ = ["RGLRUState", "init_rglru_block", "rglru_block", "init_rglru_state"]

_DECAY_C = 8.0


@dataclasses.dataclass
class RGLRUState:
    """Decode state: recurrence vector + trailing conv inputs."""

    h: torch.Tensor      # (B, W) float32
    conv: torch.Tensor   # (B, conv_width - 1, W) in the activation type


def init_rglru_state(batch: int, cfg: ModelConfig, dtype: torch.dtype,
                     device: str | torch.device = "cuda") -> RGLRUState:
    dev = resolve_device(device)
    w = cfg.lru_width or cfg.d_model
    return RGLRUState(h=torch.zeros(batch, w, dtype=torch.float32, device=dev),
                      conv=torch.zeros(batch, cfg.conv_width - 1, w, dtype=dtype, device=dev))


def init_rglru_block(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    """The JAX package's distributions: Lambda uniform in [0.3, 0.8], stored
    in float32 as ``log(expm1(Lambda))`` so that softplus gives it back."""
    d = cfg.d_model
    w = cfg.lru_width or d
    lam = torch.rand(w, generator=gen, dtype=torch.float32, device=gen.device) * 0.5 + 0.3
    return {
        "w_in": init_dense(gen, d, w, dtype),
        "w_gate": init_dense(gen, d, w, dtype),
        "conv_w": torch.randn(cfg.conv_width, w, generator=gen, dtype=dtype,
                              device=gen.device) * 0.1,
        "conv_b": torch.zeros(w, dtype=dtype, device=gen.device),
        "wa": init_dense(gen, w, w, dtype, bias=True),
        "wx": init_dense(gen, w, w, dtype, bias=True),
        "lambda_raw": torch.log(torch.expm1(lam)),
        "w_out": init_dense(gen, w, d, dtype, scale=w ** -0.5),
    }


def _causal_conv(p: dict, u: torch.Tensor, history: torch.Tensor | None) -> torch.Tensor:
    """Per-channel causal conv. u: (B, S, W); history: (B, cw-1, W) or None."""
    cw = p["conv_w"].shape[0]
    if history is None:
        history = torch.zeros(u.shape[0], cw - 1, u.shape[2], dtype=u.dtype, device=u.device)
    padded = torch.cat([history, u], dim=1)
    out = torch.zeros_like(u)
    for i in range(cw):
        out = out + padded[:, i:i + u.shape[1]] * p["conv_w"][i]
    return out + p["conv_b"]


def rglru_block(
    p: dict,
    x: torch.Tensor,               # (B, S, d)
    cfg: ModelConfig,
    state: RGLRUState | None = None,
    ctx: MeshCtx = MeshCtx(),
) -> tuple[torch.Tensor, RGLRUState | None]:
    B, S, _ = x.shape
    gate = F.gelu(dense(p["w_gate"], x), approximate="tanh")  # jax.nn.gelu's default
    raw = ctx.shard_features(dense(p["w_in"], x))
    u = _causal_conv(p, raw, state.conv if state is not None else None)

    uf = u.float()
    r = torch.sigmoid(dense(p["wa"], u).float())
    i = torch.sigmoid(dense(p["wx"], u).float())
    log_a = -_DECAY_C * per_shard(F.softplus, p["lambda_raw"].float()) * r       # (B, S, W) f32
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) * (i * uf)

    if state is not None:
        h0 = state.h
    else:
        h0 = torch.zeros(B, u.shape[-1], dtype=torch.float32, device=x.device)
    if S == 1:  # decode: one elementwise step
        h = (a[:, 0] * h0 + b[:, 0])[:, None]
    elif ctx.mesh is None:
        h = scan_ops.rglru_scan(a, b, h0)
    else:
        h = _scan_local(ctx, a, b, h0)
    new_state = None
    if state is not None:
        # Keep the last cw-1 raw inputs for the next decode step. Both new
        # tensors are copies, so the step's (B, S, W) buffers can be freed.
        tail = torch.cat([state.conv, raw], dim=1)
        cw1 = p["conv_w"].shape[0] - 1
        new_state = RGLRUState(h=h[:, -1].clone(), conv=tail[:, tail.shape[1] - cw1:].clone())

    y = ctx.shard_features(h.to(x.dtype) * gate)
    return dense(p["w_out"], y), new_state


def _scan_local(ctx: MeshCtx, a, b, h0):
    """The scan over a mesh: each rank runs B5 (and, under autograd, its
    backward) on its own (batch, channel) shard through ``local_map``; the
    recurrence is per channel, so no collective. ``a`` and ``b`` come
    placed as ``shard_features`` placed ``u``; h0 follows them."""
    from torch.distributed.tensor.experimental import local_map

    a, b = ctx.as_dtensor(a), ctx.as_dtensor(b)
    # local_map takes one output's placements as a list
    pl = list(ctx.placements(a.shape, (ctx.data_axes, None, ctx.tp_axis)))
    pl0 = list(ctx.placements(h0.shape, (ctx.data_axes, ctx.tp_axis)))
    scan = local_map(lambda a_, b_, h_: scan_ops.rglru_scan(a_.contiguous(), b_.contiguous(), h_),
                     out_placements=pl, in_placements=(pl, pl, pl0),
                     device_mesh=ctx.mesh, redistribute_inputs=True)
    return scan(a, b, ctx.as_dtensor(h0))
