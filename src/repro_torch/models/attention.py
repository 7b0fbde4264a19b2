"""GQA/MQA attention with a KV cache: prefill and one-token decode.

The port of ``repro.models.attention`` for the branches a dense model's
serving path takes. The attention itself runs through the port's kernels:

* prefill (Sq > 1) writes the new keys and values into the cache at
  ``pos``, then ``ops.flash_attention(causal=True)`` attends over the
  cache's first ``pos + Sq`` slots, read in place. This is the function
  ``repro``'s ``sdpa`` computes over the whole cache with ``kv_valid``:
  slots past ``pos + Sq`` contribute nothing;
* decode (Sq = 1) writes at ``pos``, then ``ops.decode_attention`` attends
  over the first ``pos + 1`` slots of every row.

A local-attention block (``window`` > 0) keeps a ring of at most
``window`` slots; position P lives in slot ``P % S_cache``:

* prefill (at ``pos`` 0 only) runs ``ops.flash_attention(causal=True,
  window=window)`` over the fresh keys and values, then writes the last
  ``min(Sq, S_cache)`` positions into their slots;
* decode writes at ``pos % S_cache``, then ``ops.decode_attention`` attends
  over ``min(pos + 1, S_cache)`` slots. Every slot of a ring of at most
  ``window`` slots holds a position inside the query's window and before
  it, and softmax attention over a set does not depend on the order it is
  stored in, so the ring's order needs no mask.

Without a cache, ``flash_attention`` runs over the fresh keys and values.
``sdpa`` is the plain reference of the model path. ``sdpa_chunked`` is the
reference's blocked online-softmax attention in eager torch; MLA's
expanded long-prompt branch (``models.mla``) runs it. Unlike the JAX package,
which returns new arrays, the port writes the cache tensors in place (no
second copy of every layer's cache per step) and returns a ``KVCache``
with the advanced ``pos``.

Cross-attention (Whisper's decoder, ``cross_kv`` = the encoder's keys and
values) takes no rope, writes no cache and returns the cache as given:
Sq > 1 queries go through ``ops.flash_attention(causal=False)`` over every
encoder frame, one query through ``ops.decode_attention`` with every row's
length the frame count. Encoder self-attention is ``cache=None,
causal=False``: ``flash_attention`` over the fresh keys and values.

Training (``train=True``, which ``model.loss_fn`` passes down) takes the
reference's differentiable route instead of the kernels, which have no
backward: attention without a cache, and cross-attention, through ``sdpa``
(``sdpa_chunked`` from ``CHUNKED_MIN_SEQ`` queries on), as the reference's
``attention_block`` computes it under its default ``attention_impl="xla"``.

Over a mesh (``ctx``, a ``layers.MeshCtx`` with a ``DeviceMesh``) the
queries and the attention output are placed heads over TP, as the
reference constrains them, and every branch takes that XLA route, serving
included: the reference's mesh route never reaches its Pallas kernels.
A cache is then written as the reference writes it (a whole-cache prompt
replaces it, a longer one keeps its last slots rolled into ring order,
anything shorter is written at ``pos``, or at ``pos % S_cache`` in a
ring), in place, and ``sdpa`` attends over every slot with the validity
mask and, in a ring, each slot's absolute position; from
``CHUNKED_MIN_SEQ`` queries on ``sdpa_chunked`` attends over the fresh
keys and values, as it does for a prompt longer than a ring at any length
(where the reference, below 2048 tokens, attends over the ring it just
cut: ROADMAP C-ref-6).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import MeshCtx, dense, init_dense, per_shard

__all__ = [
    "KVCache",
    "init_attention",
    "attend",
    "attention_block",
    "init_kv_cache",
    "sdpa",
    "sdpa_chunked",
]

NEG_INF = -2.0e38

# From this many queries the training route attends through
# ``sdpa_chunked``, as the reference's ``_CHUNKED_THRESHOLD_SEQ``.
CHUNKED_MIN_SEQ = 2048


@dataclasses.dataclass
class KVCache:
    """KV cache: ``k``/``v`` are (B, S_cache, Hkv, D); ``pos`` is the number
    of tokens seen, a host int, the same for every row (batched decode
    steps run in lockstep, as in the JAX package). A dense cache holds
    them in slots 0..pos-1; a local-attention ring holds the last
    ``min(pos, S_cache)`` of them, so ``pos`` may exceed ``S_cache``."""

    k: torch.Tensor
    v: torch.Tensor
    pos: int


def init_kv_cache(
    batch: int, s_cache: int, n_kv_heads: int, head_dim: int, dtype: torch.dtype,
    device: str | torch.device = "cuda",
) -> KVCache:
    dev = resolve_device(device)
    shape = (batch, s_cache, n_kv_heads, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev), pos=0)


def init_attention(
    gen: torch.Generator,
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    dtype: torch.dtype,
    qkv_bias: bool = False,
) -> dict:
    return {
        "wq": init_dense(gen, d_model, n_heads * head_dim, dtype, bias=qkv_bias),
        "wk": init_dense(gen, d_model, n_kv_heads * head_dim, dtype, bias=qkv_bias),
        "wv": init_dense(gen, d_model, n_kv_heads * head_dim, dtype, bias=qkv_bias),
        "wo": init_dense(gen, n_heads * head_dim, d_model, dtype,
                         scale=(n_heads * head_dim) ** -0.5),
    }


def sdpa(
    q: torch.Tensor,          # (B, Sq, H, D)
    k: torch.Tensor,          # (B, Sk, Hkv, D)
    v: torch.Tensor,          # (B, Sk, Hkv, D)
    *,
    causal: bool,
    window: int = 0,
    q_positions: torch.Tensor | None = None,  # (Sq,) absolute positions of queries
    kv_valid: torch.Tensor | None = None,     # (Sk,) bool, valid cache slots
    k_positions: torch.Tensor | None = None,  # (Sk,) absolute positions of keys
) -> torch.Tensor:
    """Grouped scaled-dot-product attention, the plain model-path reference.

    Operands in their own type, products accumulated in float32 (the JAX
    package's bf16-operand, f32-accumulation einsums), probabilities cast
    back to the input type before the second product.
    """
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, D) * torch.tensor(D ** -0.5, dtype=q.dtype).item()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    q_pos = q_positions if q_positions is not None else torch.arange(Sq, device=q.device)
    k_pos = k_positions if k_positions is not None else torch.arange(Sk, device=q.device)
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    if kv_valid is not None:
        mask &= kv_valid[None, :]
    scores = torch.where(mask, scores, torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.float(), v.float())
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def sdpa_chunked(
    q: torch.Tensor,          # (B, Sq, H, D)
    k: torch.Tensor,          # (B, Sk, Hkv, D)
    v: torch.Tensor,          # (B, Sk, Hkv, Dv)
    *,
    causal: bool,
    window: int = 0,
    q_chunk: int = 1024,
    k_chunk: int = 1024,
) -> torch.Tensor:
    """Blocked online-softmax attention: the reference's ``sdpa_chunked``.

    A loop over query chunks and, inside, over the key chunks the causal
    and window masks leave, carrying the running max, denominator and
    accumulator in float32; the (Sq, Sk) score matrix is never formed.
    Operands in their own type, products accumulated in float32, the
    probabilities cast to the input type before P.V, as in ``sdpa``.
    """
    B, Sq, H, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    scale = torch.tensor(D ** -0.5, dtype=q.dtype).item()
    neg_inf = torch.tensor(NEG_INF, device=q.device)
    outs = []
    for q0 in range(0, Sq, q_chunk):
        qlen = min(q_chunk, Sq - q0)
        qb = (q[:, q0:q0 + qlen] * scale).reshape(B, qlen, Hkv, G, D).float()
        q_pos = torch.arange(q0, q0 + qlen, device=q.device)
        hi = Sk if not causal else min(Sk, q0 + qlen)
        lo = 0 if not window else max(0, q0 - window + 1)
        lo = (lo // k_chunk) * k_chunk
        # The running max, denominator and accumulator start at the first
        # key chunk's (the same numbers as from -inf and zeros, and, over a
        # mesh, placed as the scores are rather than replicated).
        m = l = acc = None
        for k0 in range(lo, hi, k_chunk):
            kb, vb = k[:, k0:k0 + k_chunk], v[:, k0:k0 + k_chunk]
            s = torch.einsum("bqkgd,bskd->bkgqs", qb, kb.float())
            k_pos = torch.arange(k0, k0 + kb.shape[1], device=q.device)
            mask = torch.ones(qlen, kb.shape[1], dtype=torch.bool, device=q.device)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window:
                mask &= k_pos[None, :] > q_pos[:, None] - window
            s = torch.where(mask, s, neg_inf)
            m_new = s.amax(dim=-1) if m is None else torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(q.dtype).float(), vb.float())
            if m is None:
                l, acc = p.sum(dim=-1), pv
            else:
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(dim=-1)
                acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / l[..., None].clamp_min(1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, qlen, H, Dv).to(q.dtype))
    return torch.cat(outs, dim=1)


def attention_block(
    p: dict,
    x: torch.Tensor,                     # (B, Sq, d_model)
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    causal: bool = True,
    window: int = 0,
    rope_fn=None,                        # fn(x4d, positions) -> x4d, or None
    positions: torch.Tensor | None = None,  # (Sq,) absolute positions
    cache: KVCache | None = None,
    cross_kv=None,
    train: bool = False,
    ctx: MeshCtx = MeshCtx(),
) -> tuple[torch.Tensor, KVCache | None]:
    """Full attention sub-layer: qkv proj -> rope -> (cache write) -> attention -> out.

    Returns (output, updated cache); the cache's tensors are written in place.
    With ``cross_kv`` = (k, v), each (B, Sk, n_kv_heads, head_dim), rope and
    the cache are ignored and the cache comes back as given. ``train``
    attends through ``sdpa`` rather than the kernels (module docstring); it
    takes no cache. ``ctx`` is the mesh route (module docstring).
    """
    B, Sq, _ = x.shape
    mesh = ctx.mesh is not None
    q = ctx.split_heads(dense(p["wq"], x), n_heads)
    q = ctx.shard(q, ctx.data_axes, None, ctx.tp_axis, None)
    if cross_kv is not None:
        if train or mesh:
            out = _train_attention(q, *cross_kv, causal=False, ctx=ctx)
        else:
            out = _cross_attention(q, *cross_kv)
        out = ctx.shard(out, ctx.data_axes, None, ctx.tp_axis, None)
        return dense(p["wo"], out.reshape(B, Sq, n_heads * head_dim)), cache
    k = ctx.split_heads(dense(p["wk"], x), n_kv_heads)
    v = ctx.split_heads(dense(p["wv"], x), n_kv_heads)

    if positions is None:
        base = cache.pos if cache is not None else 0
        positions = torch.arange(base, base + Sq, device=x.device)
    if rope_fn is not None:
        q = rope_fn(q, positions)
        k = rope_fn(k, positions)

    if train or (mesh and cache is None):
        out = _train_attention(q, k, v, causal=causal, window=window, positions=positions,
                               ctx=ctx)
    elif mesh:
        out, cache = _mesh_cached_attention(q, k, v, cache, causal=causal, window=window,
                                            positions=positions, ctx=ctx)
    elif cache is None:
        out = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    elif window:
        out, cache = _ring_attention(q, k, v, cache, window, causal)
    else:
        s_cache, pos = cache.k.shape[1], cache.pos
        if pos + Sq > s_cache:
            raise ValueError(f"KV cache full: {pos} + {Sq} tokens > {s_cache} slots")
        # Rope is applied before caching, so stored keys carry their positions.
        cache.k[:, pos:pos + Sq] = k.to(cache.k.dtype)
        cache.v[:, pos:pos + Sq] = v.to(cache.v.dtype)
        cache = KVCache(k=cache.k, v=cache.v, pos=pos + Sq)
        qc = q.to(cache.k.dtype)
        if Sq == 1:
            lengths = torch.full((B,), pos + 1, dtype=torch.int32, device=x.device)
            out = decode_ops.decode_attention(qc[:, 0], cache.k, cache.v, lengths)[:, None]
        else:
            out = flash_ops.flash_attention(qc, cache.k[:, :pos + Sq], cache.v[:, :pos + Sq],
                                            causal=causal)
        out = out.to(q.dtype)
    out = ctx.shard(out, ctx.data_axes, None, ctx.tp_axis, None)
    return dense(p["wo"], out.reshape(B, Sq, n_heads * head_dim)), cache


def _mesh_cached_attention(q, k, v, cache: KVCache, *, causal: bool, window: int, positions,
                           ctx: MeshCtx):
    """The reference's cached attention, as its mesh route computes it
    (module docstring). Returns (out, cache)."""
    Sq = q.shape[1]
    s_cache, pos = cache.k.shape[1], cache.pos
    kc, vc = k.to(cache.k.dtype), v.to(cache.v.dtype)
    if Sq >= s_cache:
        # A prompt as long as the cache replaces it; a longer one (a ring)
        # keeps its last s_cache positions, rolled so slot(P) = P % s_cache.
        start = (pos + Sq - s_cache) % s_cache

        def ring(t):
            return torch.roll(t, start, dims=1)

        cache.k.copy_(per_shard(ring, kc[:, Sq - s_cache:], dims=(1,)))
        cache.v.copy_(per_shard(ring, vc[:, Sq - s_cache:], dims=(1,)))
    else:
        write = pos % s_cache if window else pos
        if write + Sq > s_cache:
            raise ValueError(f"KV cache full: {write} + {Sq} tokens > {s_cache} slots")
        cache.k[:, write:write + Sq] = kc
        cache.v[:, write:write + Sq] = vc
    total = pos + Sq
    cache = KVCache(k=cache.k, v=cache.v, pos=total)
    slots = torch.arange(s_cache, device=positions.device)
    kv_valid = slots < total
    if Sq >= CHUNKED_MIN_SEQ:  # attention over the prompt's own keys and values
        return attend(ctx, sdpa_chunked, q, k, v, causal=causal, window=window), cache
    if Sq > s_cache:
        # Below 2048 tokens the reference attends over the ring it just
        # cut (ROADMAP C-ref-6); the prompt's own keys are the right ones.
        return attend(ctx, sdpa, q, k, v, causal=causal, window=window,
                      q_positions=positions), cache
    if window and s_cache <= window:
        # A ring: slot i holds the newest position congruent to i.
        k_abs = slots + ((total - 1 - slots) // s_cache) * s_cache
        out = attend(ctx, sdpa, q, cache.k, cache.v, causal=True, window=window,
                     q_positions=positions, kv_valid=kv_valid, k_positions=k_abs)
    else:
        out = attend(ctx, sdpa, q, cache.k, cache.v, causal=causal, window=window,
                     q_positions=positions, kv_valid=kv_valid)
    return out, cache


def attend(ctx: MeshCtx, fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` (``sdpa`` or ``sdpa_chunked``); over a mesh,
    on each rank's (batch, head) shard through ``local_map``, heads over
    TP as the reference constrains the queries: attention is independent
    across both, so the shards need no collective, forward or backward.
    Keys and values whose head count TP does not divide (GQA with fewer KV
    heads than ranks) are repeated to the query heads first; masks and
    positions in ``kw`` are plain tensors, the same on every rank."""
    if ctx.mesh is None:
        return fn(q, k, v, **kw)
    from torch.distributed.tensor.experimental import local_map

    H, Hkv = q.shape[2], k.shape[2]
    tp = ctx.axis_size(ctx.tp_axis)
    if Hkv % tp and H % tp == 0:
        k, v = (ctx.as_dtensor(t).repeat_interleave(H // Hkv, dim=2) for t in (k, v))
    spec = (ctx.data_axes, None, ctx.tp_axis, None)
    pls = [list(ctx.placements(t.shape, spec)) for t in (q, k, v)]
    run = local_map(lambda q_, k_, v_: fn(q_, k_, v_, **kw), out_placements=pls[0],
                    in_placements=tuple(pls), device_mesh=ctx.mesh, redistribute_inputs=True)
    return run(*(ctx.as_dtensor(t) for t in (q, k, v)))


def _train_attention(q, k, v, *, causal: bool, window: int = 0, positions=None,
                     ctx: MeshCtx = MeshCtx()):
    """The reference's differentiable attention over fresh keys and values:
    ``sdpa`` below ``CHUNKED_MIN_SEQ`` queries, ``sdpa_chunked`` from there
    (``attend``: per shard over a mesh)."""
    if q.shape[1] >= CHUNKED_MIN_SEQ:
        return attend(ctx, sdpa_chunked, q, k, v, causal=causal, window=window)
    return attend(ctx, sdpa, q, k, v, causal=causal, window=window, q_positions=positions)


def _cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Every query over every encoder frame: B3 without a mask for a prompt,
    B4 over all Sk slots for one token."""
    B, Sq = q.shape[:2]
    if Sq > 1:
        return flash_ops.flash_attention(q, k, v, causal=False)
    lengths = torch.full((B,), k.shape[1], dtype=torch.int32, device=q.device)
    return decode_ops.decode_attention(q[:, 0], k, v, lengths)[:, None]


def _ring_attention(q, k, v, cache: KVCache, window: int, causal: bool):
    """Local attention against a ring cache; returns (out, cache)."""
    B, Sq = q.shape[:2]
    s_cache, pos = cache.k.shape[1], cache.pos
    if s_cache > window or not causal:
        raise ValueError(f"a ring cache serves causal local attention over at most window="
                         f"{window} slots; got {s_cache} slots, causal={causal}")
    if Sq > 1 and pos:
        # The reference clamps such a write at the end of the ring and, from
        # 2048 tokens on, ignores what the ring holds (ROADMAP C-ref-5);
        # serving prefills once, at position 0.
        raise NotImplementedError(
            f"prefill at pos {pos} > 0 on a local-attention ring cache is not supported: "
            "prefill once at pos 0, then decode")
    kc, vc, qc = k.to(cache.k.dtype), v.to(cache.v.dtype), q.to(cache.k.dtype)
    if Sq > 1:
        out = flash_ops.flash_attention(qc, kc, vc, causal=True, window=window)
        n = min(Sq, s_cache)
        slots = torch.arange(Sq - n, Sq, device=q.device) % s_cache
        cache.k[:, slots] = kc[:, Sq - n:]
        cache.v[:, slots] = vc[:, Sq - n:]
    else:
        cache.k[:, pos % s_cache] = kc[:, 0]
        cache.v[:, pos % s_cache] = vc[:, 0]
        lengths = torch.full((B,), min(pos + 1, s_cache), dtype=torch.int32, device=q.device)
        out = decode_ops.decode_attention(qc[:, 0], cache.k, cache.v, lengths)[:, None]
    return out.to(q.dtype), KVCache(k=cache.k, v=cache.v, pos=pos + Sq)
