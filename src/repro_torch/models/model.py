"""Config-driven composition of a decoder: init, prefill and decode.

The port of ``repro.models.model`` for dense GQA architectures (every block
``attn``: ``qwen1.5-0.5b``, ``internlm2-1.8b``, ``yi-9b``, ``starcoder2-7b``),
the Griffin hybrid (``rglru`` and ``local_attn`` blocks:
``recurrentgemma-2b``), the MoE family (routed and shared experts,
``granite-moe-1b-a400m``; with MLA attention, dense-first layers and the
MTP head's parameters, ``deepseek-v3-671b``), xLSTM (``mlstm`` and
``slstm`` blocks: ``xlstm-125m``) and the Whisper encoder-decoder
(``whisper-tiny``: a bidirectional encoder over stub frame embeddings,
sinusoidal positions and no rotary, decoder blocks with cross-attention)
and the Qwen2-VL backbone (``qwen2-vl-72b``: multimodal RoPE over (3, B, S)
temporal / height / width positions, inputs given as embeddings, the vision
front end a stub in both packages). The model is the same
sequence of segments (``segments_of``); a Python loop over each segment's
repeats replaces ``lax.scan`` and ``jax.checkpoint``. Parameters are plain
dicts of tensors with the JAX tree's names; ``params["segments"][s][i]`` is
the list, over the segment's repeats, of the dicts that the JAX package
stacks along a leading axis (``params["encoder"]["segments"]`` likewise).
Caches nest the same way.

Public entry points, each on an explicit device that defaults to
``"cuda"`` and raises without a card:

* ``init_params(cfg, seed=0, device=...)``
* ``init_caches(cfg, batch, s_cache, dtype=None, device=...)``
* ``prefill(params, cfg, batch, caches, device=...)``   — fill caches, last-token logits
* ``decode_step(params, cfg, batch, caches, device=...)`` — one-token serve step
* ``loss_fn(params, cfg, batch, device=..., remat=False)`` — training loss (chunked xent)

A model with ``cfg.embedding_inputs`` takes ``batch["embeds"]`` (B, S,
d_model) as given, unscaled, in place of ``tokens`` (a decode step passes
``tokens``, embedded and scaled as usual); with ``cfg.mrope_sections`` its
rotary angles come from ``batch["mrope_positions"]`` (3, B, S), else from
the text-only fallback, all three streams at ``pos0 + arange(S)``. The
reference's forward contract, both.

An encoder-decoder's ``batch`` carries ``encoder_out`` (the output of
``encode(params, cfg, embeds)``, which serving computes once a request
batch and hands to every step, the reference's decode contract) or
``encoder_embeds`` (the forward then runs the encoder itself).

Training: ``loss_fn(params, cfg, batch, device=...)`` is the reference's
next-token loss (``_chunked_xent`` over 512-token chunks of the sequence,
float32), plus ``0.3 *`` the MTP head's loss where the config has one and
``0.01 *`` the MoE blocks' aux loss. ``forward`` keeps its two results; the
aux loss comes out of the private ``_trunk`` that both share, which also
takes the training route: attention without a cache (and cross-attention)
through the model-path ``sdpa`` (``sdpa_chunked`` from 2048 queries), the
computation the reference differentiates, never B3 or B4, which have no
backward. With ``remat=True`` every repeat of a segment and every loss
chunk runs in ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``
under ``cfg.remat``; the port's config keeps no ``remat`` field, so the
caller passes it). RG-LRU blocks train through B5 and its backward kernel;
sLSTM blocks through the ``slstm_scan`` kernel and its backward kernels
(``slstm_scan_bwd``; in the cluster layout its loop and rest pass).
Serving drops the aux loss, as the reference's ``prefill`` and
``decode_step`` do.

The mesh route. ``forward``, ``encode``, ``prefill``, ``decode_step`` and
``loss_fn`` take ``ctx``, a ``layers.MeshCtx``; without one (or with no
mesh in it) nothing changes. Over a ``DeviceMesh`` the parameters, batch
and caches are DTensors, plain tensors made on the way (positions, masks,
rotary tables) count as replicated (``implicit_replication``), and the
reference's sharding constraints sit where its own do: the residual stream
after the embedding, the encoder's input and every block
(``shard_tokens``), the attention heads, the MLP and recurrent features
(``shard_features``), the ZeRO-3 use-site gather (``ctx.gather_weights``),
and the MoE block's expert-parallel routes (``models.moe``). Attention then
takes the reference's XLA route everywhere, ``sdpa`` and ``sdpa_chunked``,
serving included; B3 and B4 stay on the mesh-less path. B5 and its
backward run on each rank's channel shard (``models.rglru``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    MeshCtx,
    apply_rope,
    dense,
    embed_tokens,
    init_dense,
    init_embedding,
    init_mlp,
    mlp,
    mrope,
    per_shard,
    rms_norm,
    rope,
)

__all__ = [
    "Signature",
    "segments_of",
    "encoder_segments",
    "init_params",
    "init_caches",
    "forward",
    "encode",
    "prefill",
    "decode_step",
    "loss_fn",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}

# Tokens of the sequence in one chunk of the cross entropy, as the reference.
_LOSS_SEQ_CHUNK = 512


# ---------------------------------------------------------------------------
# Segmentation
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Signature:
    kind: str          # attn | local_attn | rglru | mlstm | slstm
    moe: bool
    cross: bool = False  # decoder block with cross-attention (Whisper)


def _layer_signatures(cfg: ModelConfig) -> list[Signature]:
    sigs = []
    for i, kind in enumerate(cfg.resolved_block_pattern):
        moe = cfg.is_moe and i >= cfg.n_dense_layers and kind in ("attn", "local_attn")
        sigs.append(Signature(kind=kind, moe=moe, cross=cfg.is_encoder_decoder))
    return sigs


def _smallest_period(seq: list) -> int:
    n = len(seq)
    for p in range(1, n + 1):
        if all(seq[i] == seq[i % p] for i in range(n)):
            return p
    return n


def segments_of(cfg: ModelConfig) -> list[tuple[tuple[Signature, ...], int]]:
    """[(pattern, repeats), ...] covering the decoder stack in order."""
    sigs = _layer_signatures(cfg)
    n = len(sigs)
    p = _smallest_period(sigs)
    if p <= max(4, n // 2):
        reps = n // p
        segs = [(tuple(sigs[:p]), reps)]
        if n % p:
            segs.append((tuple(sigs[reps * p:]), 1))
        return segs
    # Fallback: maximal uniform runs (handles DeepSeek's dense prefix).
    segs = []
    start = 0
    for i in range(1, n + 1):
        if i == n or sigs[i] != sigs[start]:
            segs.append(((sigs[start],), i - start))
            start = i
    return segs


def encoder_segments(cfg: ModelConfig) -> list[tuple[tuple[Signature, ...], int]]:
    """An encoder-decoder's encoder: ``encoder_layers`` attn blocks without
    cross-attention, in one segment."""
    return [((Signature(kind="attn", moe=False, cross=False),), cfg.encoder_layers)]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_block(gen: torch.Generator, cfg: ModelConfig, sig: Signature, dt: torch.dtype) -> dict:
    zeros = lambda: torch.zeros(cfg.d_model, dtype=dt, device=gen.device)  # noqa: E731
    p: dict[str, Any] = {"norm1": zeros()}
    if sig.kind in ("mlstm", "slstm"):  # the cell alone: no FFN sub-layer
        init = xlstm_lib.init_mlstm_block if sig.kind == "mlstm" else xlstm_lib.init_slstm_block
        p["cell"] = init(gen, cfg, dt)
        return p
    if sig.kind == "rglru":
        p["rec"] = rglru_lib.init_rglru_block(gen, cfg, dt)
    elif cfg.use_mla:
        p["attn"] = mla_lib.init_mla(gen, cfg, dt)
    else:
        p["attn"] = attn_lib.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, dt,
            qkv_bias=cfg.qkv_bias,
        )
    if sig.cross:
        p["cross_norm"] = zeros()
        p["cross"] = attn_lib.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_heads,
                                             cfg.resolved_head_dim, dt)
    if cfg.d_ff or sig.kind != "rglru":
        p["norm2"] = zeros()
    if sig.moe:
        p["moe"] = moe_lib.init_moe(gen, cfg, dt)
    elif cfg.d_ff:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dt)
    return p


def _init_segments(gen: torch.Generator, cfg: ModelConfig, segs, dt: torch.dtype) -> list:
    return [[[_init_block(gen, cfg, sig, dt) for _ in range(reps)] for sig in pattern]
            for pattern, reps in segs]


def init_params(cfg: ModelConfig, seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """Random parameters (normal * fan-in^-1/2, zero norms and biases, as the
    JAX package draws them) from a ``torch.Generator`` seeded with ``seed``
    on ``device``. The numbers are not ``jax.random``'s."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = _DTYPES[cfg.param_dtype]
    params: dict[str, Any] = {
        "embed": init_embedding(gen, cfg.padded_vocab, cfg.d_model, dt),
        "final_norm": torch.zeros(cfg.d_model, dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_dense(gen, cfg.d_model, cfg.padded_vocab, dt,
                                       scale=cfg.d_model ** -0.5)
    params["segments"] = _init_segments(gen, cfg, segments_of(cfg), dt)
    if cfg.is_encoder_decoder:
        params["encoder"] = {
            "segments": _init_segments(gen, cfg, encoder_segments(cfg), dt),
            "final_norm": torch.zeros(cfg.d_model, dtype=dt, device=dev),
        }
    if cfg.mtp_depth:
        # DeepSeek MTP: projection of [h ; emb(next)] + one extra dense block.
        # Carried for the training slice; serving does not run it.
        params["mtp"] = {
            "proj": init_dense(gen, 2 * cfg.d_model, cfg.d_model, dt),
            "norm_h": torch.zeros(cfg.d_model, dtype=dt, device=dev),
            "norm_e": torch.zeros(cfg.d_model, dtype=dt, device=dev),
            "block": _init_block(gen, cfg, Signature(kind="attn", moe=False), dt),
        }
    return params


def _init_cache_for(sig: Signature, cfg: ModelConfig, batch: int, s_cache: int,
                    dtype: torch.dtype, device):
    if sig.kind == "rglru":
        return rglru_lib.init_rglru_state(batch, cfg, dtype, device)
    if sig.kind == "mlstm":
        return xlstm_lib.init_mlstm_state(batch, cfg, dtype, device)
    if sig.kind == "slstm":
        return xlstm_lib.init_slstm_state(batch, cfg, dtype, device)
    if cfg.use_mla:
        return mla_lib.init_mla_cache(batch, s_cache, cfg, dtype, device)
    size = min(s_cache, cfg.local_window) if sig.kind == "local_attn" else s_cache
    return attn_lib.init_kv_cache(batch, size, cfg.n_kv_heads, cfg.resolved_head_dim,
                                  dtype, device)


def init_caches(cfg: ModelConfig, batch: int, s_cache: int, dtype: torch.dtype | None = None,
                device: str | torch.device = "cuda") -> list:
    """Empty caches, nested [segment][pattern entry][repeat]: a ``KVCache``
    per attention block (a ring of ``min(s_cache, local_window)`` slots for
    ``local_attn``; an ``MLACache`` under MLA), an ``RGLRUState`` per ``rglru``
    block, an ``MLSTMState`` or ``SLSTMState`` (float32) per xLSTM block. An
    encoder-decoder's encoder keeps no cache."""
    dtype = dtype or _DTYPES[cfg.dtype]
    return [
        [[_init_cache_for(sig, cfg, batch, s_cache, dtype, device) for _ in range(reps)]
         for sig in pattern]
        for pattern, reps in segments_of(cfg)
    ]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


_NO_MESH = MeshCtx()


def _cross_sublayer(p: dict, x: torch.Tensor, cfg: ModelConfig,
                    encoder_out: torch.Tensor, train: bool = False,
                    ctx: MeshCtx = _NO_MESH) -> torch.Tensor:
    """Cross-attention over the encoder's output, its keys and values
    projected at every step, as the reference does."""
    h = rms_norm(p["cross_norm"], x, cfg.norm_eps)
    k = ctx.split_heads(dense(p["cross"]["wk"], encoder_out), cfg.n_heads)
    v = ctx.split_heads(dense(p["cross"]["wv"], encoder_out), cfg.n_heads)
    y, _ = attn_lib.attention_block(p["cross"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_heads,
                                    head_dim=cfg.resolved_head_dim, cross_kv=(k, v), train=train,
                                    ctx=ctx)
    return x + y


def _apply_block(p: dict, sig: Signature, x: torch.Tensor, cfg: ModelConfig, cache, *,
                 rope_fn, positions, encoder_out=None, causal: bool = True, train: bool = False,
                 ctx: MeshCtx = _NO_MESH):
    """One block. Returns (x, new cache, aux): aux is the MoE block's float32
    aux loss, None for a block without experts."""
    if ctx.gather_weights:
        p = ctx.gather_params(p)  # ZeRO-3 use-site weight gather (MeshCtx)
    h = rms_norm(p["norm1"], x, cfg.norm_eps)
    if sig.kind == "mlstm":
        y, new_cache = xlstm_lib.mlstm_block(p["cell"], h, cfg, state=cache, ctx=ctx)
        return x + y, new_cache, None
    if sig.kind == "slstm":
        y, new_cache = xlstm_lib.slstm_block(p["cell"], h, cfg, state=cache, ctx=ctx, train=train)
        return x + y, new_cache, None
    if sig.kind == "rglru":
        y, new_cache = rglru_lib.rglru_block(p["rec"], h, cfg, state=cache, ctx=ctx)
    elif cfg.use_mla:
        y, new_cache = mla_lib.mla_block(p["attn"], h, cfg, positions=positions, cache=cache,
                                         ctx=ctx)
    else:
        y, new_cache = attn_lib.attention_block(
            p["attn"], h,
            n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim,
            causal=causal,
            window=cfg.local_window if sig.kind == "local_attn" else 0,
            rope_fn=rope_fn,
            positions=positions,
            cache=cache,
            train=train,
            ctx=ctx,
        )
    # The residual stream placed as at the block's end: GSPMD carries that
    # constraint back through the add, DTensor does not (a constraint the
    # reference does not write; no-op without a mesh).
    x = ctx.shard_tokens(x + y)
    if sig.cross:
        x = _cross_sublayer(p, x, cfg, encoder_out, train=train, ctx=ctx)
    aux = None
    if sig.moe:
        y, aux = moe_lib.moe_block(p["moe"], rms_norm(p["norm2"], x, cfg.norm_eps), cfg, ctx=ctx)
        x = x + y
    elif "mlp" in p:
        x = x + mlp(p["mlp"], rms_norm(p["norm2"], x, cfg.norm_eps), ctx)
    return x, new_cache, aux


def _run_segments(seg_params: list, segs, x: torch.Tensor, cfg: ModelConfig, caches, *,
                  remat: bool = False, ctx: MeshCtx = _NO_MESH, **kw):
    """Every block of ``segs`` in order. Returns (x, new caches or None, the
    MoE blocks' aux losses in block order). With ``remat`` each repeat of a
    segment's pattern runs in ``torch.utils.checkpoint``, as the reference's
    ``jax.checkpoint`` wraps its scan body (training only: no caches)."""
    new_caches = [] if caches is not None else None
    auxes = []
    for si, (pattern, reps) in enumerate(segs):
        seg_out = [[None] * reps for _ in pattern]
        for r in range(reps):
            layer = [seg_params[si][pi][r] for pi in range(len(pattern))]

            def repeat(x, layer=layer, pattern=pattern, si=si, r=r, seg_out=seg_out):
                aux_r = []
                for pi, sig in enumerate(pattern):
                    cache = caches[si][pi][r] if caches is not None else None
                    x, seg_out[pi][r], aux = _apply_block(layer[pi], sig, x, cfg, cache,
                                                          ctx=ctx, **kw)
                    # Block boundary: under sequence parallelism this
                    # re-shards the residual stream over the TP axis.
                    x = ctx.shard_tokens(x)
                    aux_r += [aux] if aux is not None else []
                return x, aux_r

            x, aux_r = checkpoint(repeat, x, use_reentrant=False) if remat else repeat(x)
            auxes += aux_r
        if new_caches is not None:
            new_caches.append(seg_out)
    return x, new_caches, auxes


def _sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(S, d) float32 absolute position embeddings: sines then cosines. The
    frequency step is the reference's float32 log(10000) / (d/2 - 1)."""
    half = d // 2
    step = torch.log(torch.tensor(10000.0, device=positions.device)) / (half - 1)
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=positions.device) * step)
    ang = positions.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def encode(params: dict, cfg: ModelConfig, embeds: torch.Tensor, *, train: bool = False,
           remat: bool = False, ctx: MeshCtx | None = None) -> torch.Tensor:
    """The encoder of an encoder-decoder: frame embeddings (B, encoder_seq,
    d_model) plus sinusoidal positions, ``encoder_layers`` bidirectional
    attn blocks without rotary or cache, then the encoder's final norm.
    ``train`` and ``remat`` are ``loss_fn``'s route, ``ctx`` the mesh
    route (module docstring)."""
    ctx = ctx or _NO_MESH
    with ctx.scope():
        S = embeds.shape[1]
        x = embeds + _sinusoidal(torch.arange(S, device=embeds.device), cfg.d_model).to(
            embeds.dtype)[None]
        x = ctx.shard_tokens(x)
        x, _, _ = _run_segments(params["encoder"]["segments"], encoder_segments(cfg), x, cfg,
                                None, rope_fn=None, positions=None, causal=False, train=train,
                                remat=remat, ctx=ctx)
        return rms_norm(params["encoder"]["final_norm"], x, cfg.norm_eps)


def forward(params: dict, cfg: ModelConfig, batch: dict, caches=None, *,
            ctx: MeshCtx | None = None) -> tuple[torch.Tensor, Any]:
    """Trunk forward. Returns (hidden (B, S, d), new caches).

    ``batch["tokens"]`` is (B, S) on the parameters' device, or, with
    ``cfg.embedding_inputs``, ``batch["embeds"]`` (B, S, d); positions start
    at ``batch["pos0"]``, else at the caches' ``pos``, else at 0, and M-RoPE
    takes ``batch["mrope_positions"]`` where given. An encoder-decoder also
    takes ``batch["encoder_out"]`` or, without it, ``batch["encoder_embeds"]``.
    ``ctx`` is the mesh route (module docstring).
    """
    h, caches, _auxes, _rope_fn = _trunk(params, cfg, batch, caches, ctx=ctx or _NO_MESH)
    return h, caches


def _trunk(params: dict, cfg: ModelConfig, batch: dict, caches=None, *, train: bool = False,
           remat: bool = False, ctx: MeshCtx = _NO_MESH):
    """``forward``'s body. Returns (hidden, new caches, the MoE blocks' aux
    losses, the rotary function of the blocks or None); ``train`` and
    ``remat`` are ``loss_fn``'s route, ``ctx`` the mesh route (module
    docstring)."""
    with ctx.scope():
        return _trunk_body(params, cfg, batch, caches, train=train, remat=remat, ctx=ctx)


def _trunk_body(params, cfg, batch, caches, *, train, remat, ctx):
    if cfg.embedding_inputs and "embeds" in batch:
        x = batch["embeds"]  # as given: the front end's scale, not sqrt(d_model)
    else:
        x = embed_tokens(params["embed"], batch["tokens"])
        # The scale rounded to the activation type first, as the JAX package does.
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
    x = ctx.shard_tokens(x)

    pos0 = batch.get("pos0")
    if pos0 is None:
        pos0 = _first_cache_pos(caches) if caches is not None else 0
    S = x.shape[1]
    positions = torch.arange(int(pos0), int(pos0) + S, device=x.device)

    encoder_out, rope_fn = None, None
    if cfg.is_encoder_decoder:
        encoder_out = batch.get("encoder_out")
        if encoder_out is None:
            encoder_out = encode(params, cfg, batch["encoder_embeds"], train=train, remat=remat,
                                 ctx=ctx)
        # Absolute sinusoidal positions, no rotary.
        x = x + _sinusoidal(positions, cfg.d_model).to(x.dtype)[None]
    else:
        # Once for all layers; an MLA block rotates its rope slice itself.
        if cfg.mrope_sections:
            pos3 = batch.get("mrope_positions")
            if pos3 is None:  # text only: the three streams share the positions
                pos3 = positions[None, None, :].expand(3, x.shape[0], S)
            # (B, S, D/2) tables: each row of the batch has its own positions.
            cos, sin = mrope(pos3, cfg.resolved_head_dim, cfg.mrope_sections, cfg.rope_theta)
        else:
            cos, sin = rope(positions, cfg.resolved_head_dim, cfg.rope_theta)

        def rope_fn(t, _positions):
            return apply_rope(t, cos, sin)

    h, caches, auxes = _run_segments(params["segments"], segments_of(cfg), x, cfg, caches,
                                     rope_fn=rope_fn, positions=positions,
                                     encoder_out=encoder_out, train=train, remat=remat,
                                     ctx=ctx)
    return h, caches, auxes, rope_fn


def _first_cache_pos(caches) -> int:
    """Tokens seen so far: the ``pos`` of the first ``KVCache`` or
    ``MLACache`` (recurrent states carry none); 0 for a model without
    attention caches."""
    for seg in caches:
        for entry in seg:
            if isinstance(entry[0], (attn_lib.KVCache, mla_lib.MLACache)):
                return entry[0].pos
    return 0


def _logits(params: dict, cfg: ModelConfig, h: torch.Tensor, ctx: MeshCtx = _NO_MESH
            ) -> torch.Tensor:
    """(B, S, padded_vocab) logits; padding columns masked to -1e30 so they
    never win an argmax. Over a mesh they are left as computed: serving
    cuts them off and the loss masks them on its shards
    (``_xent_sharded``)."""
    h = rms_norm(params["final_norm"], h, cfg.norm_eps)
    if cfg.tie_embeddings or "lm_head" not in params:
        logits = h @ params["embed"]["table"].T
    else:
        logits = h @ params["lm_head"]["w"]
    if cfg.padded_vocab != cfg.vocab_size and ctx.mesh is None:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def _chunked_xent(params: dict, cfg: ModelConfig, h: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor, remat: bool = False,
                  ctx: MeshCtx = _NO_MESH) -> torch.Tensor:
    """Mean next-token cross entropy over the unmasked positions, without
    (B, S, V) logits: chunks of ``_LOSS_SEQ_CHUNK`` positions, each its
    float32 ``logsumexp`` minus the gold logit, sums and counts in float32
    (a gather of the gold logit where the reference contracts a one-hot:
    the same number). Each chunk in ``torch.utils.checkpoint`` under
    ``remat``, as the reference's in ``jax.checkpoint``. Over a mesh
    (``ctx``) each chunk runs ``_xent_sharded``."""

    def piece(hc, yc, mc):
        logits = _logits(params, cfg, hc, ctx).float()
        if ctx.mesh is not None:
            return _xent_sharded(ctx, logits, yc, mc, cfg.vocab_size)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, yc[..., None].long())[..., 0]
        return ((lse - gold) * mc).sum(), mc.sum()

    S = h.shape[1]
    chunk = min(_LOSS_SEQ_CHUNK, S)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for s0 in range(0, S, chunk):
        args = (h[:, s0:s0 + chunk], labels[:, s0:s0 + chunk], mask[:, s0:s0 + chunk].float())
        t, c = checkpoint(piece, *args, use_reentrant=False) if remat else piece(*args)
        total = total + t
        count = count + c
    return total / torch.clamp(count, min=1.0)


def _xent_sharded(ctx: MeshCtx, logits, labels, mask, vocab: int):
    """One loss chunk over a mesh: (sum of masked token losses, mask sum),
    each a DTensor. On each rank's (batch, vocabulary) shard of the logits,
    through ``local_map``: the max over the vocabulary all-reduced (no
    gradient), the shard's sum of exponentials and its gold logit (the
    reference's one-hot contraction, over the shard's slice of the
    vocabulary) all-reduced over TP, as GSPMD reduces over a sharded
    vocabulary where DTensor's own logsumexp would gather it; padding
    columns (from ``vocab`` on) are masked to -1e30 there. Where TP does
    not shard the vocabulary, each rank computes the mesh-less chunk on
    its batch shard. The sums come out partial over the data axes."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.dist import collectives as coll

    mesh, tp = ctx.mesh, (ctx.tp_axis,)
    lg_pl = list(ctx.placements(logits.shape, (ctx.data_axes, None, ctx.tp_axis)))
    tok_pl = list(ctx.placements(labels.shape, (ctx.data_axes, None)))
    sum_pl = [Partial() if a in ctx.data_axes else Replicate() for a in mesh.mesh_dim_names]
    sharded = (ctx.axis_size(tp) > 1
               and lg_pl[mesh.mesh_dim_names.index(ctx.tp_axis)] != Replicate())
    v0 = mesh.get_local_rank(ctx.tp_axis) * (logits.shape[-1] // ctx.axis_size(tp)) \
        if sharded else 0

    def body(lg, y, mc):
        if vocab < v0 + lg.shape[-1]:
            lg = lg.clone()
            lg[..., max(vocab - v0, 0):] = -1e30
        if not sharded:  # the vocabulary whole on every rank: the mesh-less numbers
            lse = torch.logsumexp(lg, dim=-1)
            gold = lg.gather(-1, y[..., None].long())[..., 0]
            return ((lse - gold) * mc).sum(), mc.sum()
        m = coll.pmax(lg.amax(dim=-1), mesh, tp)
        se = coll.psum(torch.exp(lg - m[..., None]).sum(dim=-1), mesh, tp)
        local = (y >= v0) & (y < v0 + lg.shape[-1])
        hot = torch.nn.functional.one_hot(torch.where(local, y.long() - v0, 0), lg.shape[-1])
        gold = coll.psum(torch.einsum("bsv,bsv->bs", lg, (hot * local[..., None]).to(lg.dtype)),
                         mesh, tp)
        lse = torch.log(se) + m
        return ((lse - gold) * mc).sum(), mc.sum()

    run = local_map(body, out_placements=(sum_pl, sum_pl), in_placements=(lg_pl, tok_pl, tok_pl),
                    device_mesh=mesh, redistribute_inputs=True)
    return run(ctx.as_dtensor(logits), ctx.as_dtensor(labels), ctx.as_dtensor(mask))


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, device: str | torch.device = "cuda",
            *, remat: bool = False, ctx: MeshCtx | None = None) -> torch.Tensor:
    """Next-token LM loss (+ MoE aux + MTP head where configured): a float32
    scalar to differentiate with respect to ``params``.

    ``batch`` as ``forward`` takes it; labels are ``batch["labels"]``, else
    the tokens shifted by one (an embedding-input model needs explicit
    labels), and the mask ``batch["mask"]``, else ones with the last column
    zero. ``remat`` recomputes every repeat and loss chunk in the backward
    pass. RG-LRU blocks differentiate through B5 and its hand-written
    backward (``kernels.rglru_scan.ops``). ``ctx`` is the mesh route
    (module docstring).
    """
    tokens, labels = batch.get("tokens"), batch.get("labels")
    if labels is None and tokens is None:
        raise ValueError("embedding-input models need explicit labels")
    batch = _on_device(params, batch, device)
    ctx = ctx or _NO_MESH
    with ctx.scope():
        return _loss_body(params, cfg, batch, labels, remat, ctx)


def _loss_body(params, cfg, batch, labels, remat, ctx):
    table = params["embed"]["table"]
    tokens = batch.get("tokens")
    h, _, auxes, rope_fn = _trunk(params, cfg, batch, train=True, remat=remat, ctx=ctx)
    if labels is None:
        labels = _shifted(tokens, 1)
    labels = torch.as_tensor(labels, device=table.device)
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=table.device)
        mask[:, -1] = 0.0
    loss = _chunked_xent(params, cfg, h, labels, torch.as_tensor(mask, device=table.device),
                         remat, ctx=ctx)

    if cfg.mtp_depth and "mtp" in params and not cfg.embedding_inputs:
        # Predict token t+2 from [h_t ; emb(token_{t+1})].
        p = params["mtp"]
        emb_next = ctx.shard_tokens(  # over a mesh: the lookup's partial sum reduced
            embed_tokens(params["embed"], _shifted(tokens, 1)))
        hh = torch.cat([rms_norm(p["norm_h"], h, cfg.norm_eps),
                        rms_norm(p["norm_e"], emb_next, cfg.norm_eps)], dim=-1)
        hh = dense(p["proj"], hh)
        hh, _, _ = _apply_block(p["block"], Signature(kind="attn", moe=False), hh, cfg, None,
                                rope_fn=rope_fn, positions=torch.arange(hh.shape[1],
                                                                        device=hh.device),
                                train=True, ctx=ctx)
        labels2 = _shifted(tokens, 2)
        mask2 = torch.ones(labels2.shape, dtype=torch.float32, device=table.device)
        mask2[:, -2:] = 0.0
        loss = loss + 0.3 * _chunked_xent(params, cfg, hh, labels2, mask2, remat, ctx=ctx)

    return loss + 0.01 * sum(auxes)


def _shifted(tokens: torch.Tensor, n: int) -> torch.Tensor:
    """(B, S) tokens moved n positions left, zeros after the end (on each
    batch shard over a mesh: some DTensor releases mis-plan the pad)."""
    return per_shard(lambda t: torch.nn.functional.pad(t[:, n:], (0, n)), tokens, dims=(1,))


def _on_device(params: dict, batch: dict, device) -> dict:
    """The batch with its tokens and M-RoPE positions on ``device``, after
    checking the request and that the parameters (and the input embeddings
    or an encoder-decoder's encoder inputs) lie there."""
    dev = resolve_device(device)
    table = params["embed"]["table"]
    if table.device.type != dev.type:
        raise ValueError(f"parameters lie on {table.device}, not {dev}")
    for key in ("embeds", "encoder_out", "encoder_embeds"):
        if key in batch and batch[key].device != table.device:
            raise ValueError(f"batch[{key!r}] lies on {batch[key].device}, not {table.device}")
    return {**batch, **{key: torch.as_tensor(batch[key], device=table.device)
                        for key in ("tokens", "mrope_positions") if key in batch}}


def prefill(params: dict, cfg: ModelConfig, batch: dict, caches,
            device: str | torch.device = "cuda", *, ctx: MeshCtx | None = None):
    """Run the full prompt through the model, filling caches.

    Returns (last-token logits (B, vocab_size), caches). ``ctx`` is the
    mesh route (module docstring).
    """
    batch = _on_device(params, batch, device)
    ctx = ctx or _NO_MESH
    h, caches = forward(params, cfg, batch, caches=caches, ctx=ctx)
    with ctx.scope():
        logits = _logits(params, cfg, h[:, -1:], ctx)
        return logits[:, 0, :cfg.vocab_size], caches


def decode_step(params: dict, cfg: ModelConfig, batch: dict, caches,
                device: str | torch.device = "cuda", *, ctx: MeshCtx | None = None):
    """One-token decode. batch["tokens"]: (B, 1) (and, under M-RoPE, the
    step's ``mrope_positions`` (3, B, 1)). Returns (logits (B, vocab_size), caches).

    The same computation as ``prefill`` over one token: the attention and
    mLSTM blocks take their decode branch from the token count."""
    return prefill(params, cfg, batch, caches, device=device, ctx=ctx)
