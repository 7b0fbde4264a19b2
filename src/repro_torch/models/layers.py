"""Common layers of a dense GQA block: RMS norm, rotary embeddings, dense
projections, the SwiGLU MLP and token embeddings.

The port of the parts of ``repro.models.layers`` that a dense block uses,
with the same parameter dicts (``{"w": (d_in, d_out), "b": (d_out,)}``,
``{"table": (vocab, d)}``) and the same float32 islands (norms and rotary
rotation compute in float32 and cast back). Init functions draw from an
explicit ``torch.Generator`` and create the tensors on its device; they do
not give ``jax.random``'s numbers, so tests hand both packages the same
parameters through ``repro_torch.models.convert``. ``MeshCtx`` and the
sharding helpers are TPU tooling (ROADMAP A15). ``mrope`` builds
qwen2-vl's multimodal rotary tables, which ``apply_rope`` applies.
``layer_norm`` and the GELU MLP are public layers of the reference that no
model of either package calls (Whisper's blocks use ``rms_norm`` and the
SwiGLU ``mlp``, as the reference's do).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "rms_norm",
    "layer_norm",
    "rope",
    "apply_rope",
    "mrope",
    "apply_mrope",
    "init_dense",
    "dense",
    "init_mlp",
    "mlp",
    "init_gelu_mlp",
    "gelu_mlp",
    "init_embedding",
    "embed_tokens",
]


def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def layer_norm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm in float32, cast back. No model of either package calls it."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def rope(positions: torch.Tensor, dim: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., S) int positions -> cos/sin of shape (..., S, dim/2), float32."""
    exponents = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    freqs = 1.0 / (theta ** exponents)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of the head dim (not interleaved pairs).

    x: (B, S, H, D); cos/sin: (S, D/2) or (B, S, D/2).
    """
    dtype = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    if cos.ndim == 2:  # (S, D/2) -> broadcast over batch and heads
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:              # (B, S, D/2)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(dtype)


def mrope(positions: torch.Tensor, dim: int, sections, theta: float
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Multimodal RoPE tables (Qwen2-VL): (3, B, S) int temporal / height /
    width positions -> cos/sin of shape (B, S, dim/2), float32.

    ``sections`` are in pair units and sum to dim/2; section i takes the
    contiguous frequency slots after the previous sections' (the reference's
    layout, not HF's interleaving) and its own position stream. Angles are
    float32 position times float32 frequency, as the reference rounds them.
    """
    if sum(sections) != dim // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to {dim // 2}")
    exponents = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    freqs = 1.0 / (theta ** exponents)
    cos_parts, sin_parts = [], []
    off = 0
    for i, sec in enumerate(sections):
        ang = positions[i].float()[..., None] * freqs[off:off + sec]  # (B, S, sec)
        cos_parts.append(torch.cos(ang))
        sin_parts.append(torch.sin(ang))
        off += sec
    return torch.cat(cos_parts, dim=-1), torch.cat(sin_parts, dim=-1)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, sections, theta: float) -> torch.Tensor:
    """Rotate x (B, S, H, D) by M-RoPE at (3, B, S) positions (``mrope``)."""
    return apply_rope(x, *mrope(positions, x.shape[-1], sections, theta))


def init_dense(
    gen: torch.Generator,
    d_in: int,
    d_out: int,
    dtype: torch.dtype,
    bias: bool = False,
    scale: float | None = None,
) -> dict:
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn(d_in, d_out, generator=gen, dtype=dtype, device=gen.device) * scale
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=gen.device)
    return p


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype) -> dict:
    """Gated SwiGLU MLP (llama-style)."""
    return {
        "w_gate": init_dense(gen, d_model, d_ff, dtype),
        "w_up": init_dense(gen, d_model, d_ff, dtype),
        "w_down": init_dense(gen, d_ff, d_model, dtype, scale=d_ff ** -0.5),
    }


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    return dense(p["w_down"], F.silu(dense(p["w_gate"], x)) * dense(p["w_up"], x))


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype) -> dict:
    """Plain GELU MLP with biases (Whisper/StarCoder2-style). No model of
    either package calls it."""
    return {
        "w_fc": init_dense(gen, d_model, d_ff, dtype, bias=True),
        "w_out": init_dense(gen, d_ff, d_model, dtype, bias=True, scale=d_ff ** -0.5),
    }


def gelu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The tanh GELU (``jax.nn.gelu``'s default). No model of either package
    calls it."""
    return dense(p["w_out"], F.gelu(dense(p["w_fc"], x), approximate="tanh"))


def init_embedding(gen: torch.Generator, vocab: int, d_model: int, dtype: torch.dtype) -> dict:
    return {"table": torch.randn(vocab, d_model, generator=gen, dtype=dtype,
                                 device=gen.device) * 0.02}


def embed_tokens(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]
