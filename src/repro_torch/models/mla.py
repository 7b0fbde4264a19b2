"""Multi-head Latent Attention (DeepSeek-V2/V3).

The port of ``repro.models.mla``. Queries and keys/values come through
low-rank latents:

* q: d_model -> q_lora_rank -> n_heads x (qk_nope_dim + qk_rope_dim);
* kv: d_model -> kv_lora_rank (cached) -> per-head nope key and value,
  plus one rope key of qk_rope_dim shared by every head (cached beside it).

The decode cache holds only the compressed latent and the shared rope key
per position. Attention takes one of two forms, as in the reference:

* absorbed (decode, and prompts under 2048 tokens or with a longer
  cache): ``wk_b`` is folded into the queries and ``wv_b`` applied after
  the probabilities, so scores and values run against the latent itself;
  float32 throughout, the result cast back to the activation type;
* expanded (a prompt of 2048 tokens or more that fills the whole cache,
  or has none): per-head keys and values are formed from the latent and
  ``attention.sdpa_chunked`` attends over them.

Unlike the JAX package, which returns new arrays, the port writes the
cache's tensors in place at ``pos`` and returns an ``MLACache`` with the
advanced ``pos``; a prompt as long as the cache fills it whole, which is
the reference's replacement branch.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.models.attention import NEG_INF, attend, sdpa_chunked
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MeshCtx, apply_rope, dense, init_dense, rms_norm, rope

__all__ = ["MLACache", "init_mla", "init_mla_cache", "mla_block"]

# The reference's literal: from this many query positions on, a prompt
# that fills the whole cache (or has none) takes the expanded form.
EXPANDED_MIN_SEQ = 2048


@dataclasses.dataclass
class MLACache:
    """Compressed decode cache: ``latent`` (B, S, kv_lora), ``k_rope``
    (B, S, rope_d); ``pos`` is the number of tokens seen, a host int, the
    same for every row (as ``KVCache.pos``)."""

    latent: torch.Tensor
    k_rope: torch.Tensor
    pos: int


def init_mla_cache(batch: int, s_cache: int, cfg: ModelConfig, dtype: torch.dtype,
                   device: str | torch.device = "cuda") -> MLACache:
    dev = resolve_device(device)
    return MLACache(
        latent=torch.zeros(batch, s_cache, cfg.kv_lora_rank, dtype=dtype, device=dev),
        k_rope=torch.zeros(batch, s_cache, cfg.qk_rope_dim, dtype=dtype, device=dev),
        pos=0,
    )


def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    h, dq = cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim
    zeros = lambda n: torch.zeros(n, dtype=dtype, device=gen.device)  # noqa: E731
    return {
        "wq_a": init_dense(gen, cfg.d_model, cfg.q_lora_rank, dtype),
        "q_norm": zeros(cfg.q_lora_rank),
        "wq_b": init_dense(gen, cfg.q_lora_rank, h * dq, dtype),
        "wkv_a": init_dense(gen, cfg.d_model, cfg.kv_lora_rank + cfg.qk_rope_dim, dtype),
        "kv_norm": zeros(cfg.kv_lora_rank),
        "wk_b": init_dense(gen, cfg.kv_lora_rank, h * cfg.qk_nope_dim, dtype),
        "wv_b": init_dense(gen, cfg.kv_lora_rank, h * cfg.v_head_dim, dtype),
        "wo": init_dense(gen, h * cfg.v_head_dim, cfg.d_model, dtype,
                         scale=(h * cfg.v_head_dim) ** -0.5),
    }


def mla_block(
    p: dict,
    x: torch.Tensor,                          # (B, Sq, d)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor | None = None,    # (Sq,) absolute positions
    cache: MLACache | None = None,
    ctx: MeshCtx = MeshCtx(),
) -> tuple[torch.Tensor, MLACache | None]:
    """Returns (output (B, Sq, d), updated cache); the cache is written in
    place. ``ctx`` places the expanded heads and the output over a mesh, at
    the reference's constraints."""
    B, Sq, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv, L = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank

    # --- queries ---
    q_lat = rms_norm(p["q_norm"], dense(p["wq_a"], x), cfg.norm_eps)
    q = dense(p["wq_b"], q_lat).reshape(B, Sq, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]

    # --- compressed kv latent + shared rope key ---
    kv = dense(p["wkv_a"], x)
    latent = rms_norm(p["kv_norm"], kv[..., :L], cfg.norm_eps)
    k_rope_new = kv[..., L:]                   # (B, Sq, dr), shared by every head

    if positions is None:
        base = cache.pos if cache is not None else 0
        positions = torch.arange(base, base + Sq, device=x.device)
    cos, sin = rope(positions, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope_new = apply_rope(k_rope_new[:, :, None, :], cos, sin)[:, :, 0, :]

    kv_valid = None
    if cache is not None:
        s_cache, pos = cache.latent.shape[1], cache.pos
        if pos + Sq > s_cache:
            raise ValueError(f"MLA cache full: {pos} + {Sq} tokens > {s_cache} slots")
        cache.latent[:, pos:pos + Sq] = latent.to(cache.latent.dtype)
        cache.k_rope[:, pos:pos + Sq] = k_rope_new.to(cache.k_rope.dtype)
        cache = MLACache(latent=cache.latent, k_rope=cache.k_rope, pos=pos + Sq)
        latent_all, k_rope_all = cache.latent, cache.k_rope
        kv_valid = torch.arange(s_cache, device=x.device) < cache.pos
    else:
        latent_all, k_rope_all = latent, k_rope_new

    if Sq >= EXPANDED_MIN_SEQ and latent_all.shape[1] == Sq:
        k_nope = dense(p["wk_b"], latent_all).reshape(B, Sq, h, dn)
        k_full = torch.cat([k_nope, k_rope_all[:, :, None, :].expand(B, Sq, h, dr)], dim=-1)
        v_full = dense(p["wv_b"], latent_all).reshape(B, Sq, h, dv)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        # The expanded heads stay TP-sharded (the reference's constraints).
        q_full, k_full, v_full = (ctx.shard(t, ctx.data_axes, None, ctx.tp_axis, None)
                                  for t in (q_full, k_full, v_full))
        out = attend(ctx, sdpa_chunked, q_full, k_full, v_full, causal=True)
        out = ctx.shard(out, ctx.data_axes, None, ctx.tp_axis, None)
        return dense(p["wo"], out.reshape(B, Sq, h * dv)), cache

    # --- absorbed attention: score = (q_nope @ wk_b^T) . latent ---
    wk_b = p["wk_b"]["w"].reshape(L, h, dn).float()
    q_abs = torch.einsum("bqhd,lhd->bqhl", q_nope.float(), wk_b)        # (B, Sq, h, L)
    lat = latent_all.float()
    scores = torch.einsum("bqhl,bsl->bhqs", q_abs, lat)
    scores = scores + torch.einsum("bqhd,bsd->bhqs", q_rope.float(), k_rope_all.float())
    scores = scores * (dn + dr) ** -0.5

    k_pos = torch.arange(latent_all.shape[1], device=x.device)
    mask = positions[:, None] >= k_pos[None, :]
    if kv_valid is not None:
        mask &= kv_valid[None, :]
    scores = torch.where(mask, scores, torch.tensor(NEG_INF, device=x.device))
    probs = torch.softmax(scores, dim=-1)

    # values through the latent as well: out_h = probs . latent @ wv_b
    probs_lat = torch.einsum("bhqs,bsl->bqhl", probs, lat)
    wv_b = p["wv_b"]["w"].reshape(L, h, dv).float()
    out = torch.einsum("bqhl,lhd->bqhd", probs_lat, wv_b).to(x.dtype)
    out = ctx.shard(out, ctx.data_axes, None, ctx.tp_axis, None)
    return dense(p["wo"], out.reshape(B, Sq, h * dv)), cache
