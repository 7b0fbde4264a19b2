"""Common layers of a dense GQA block: RMS norm, rotary embeddings, dense
projections, the SwiGLU MLP and token embeddings.

The port of the parts of ``repro.models.layers`` that a dense block uses,
with the same parameter dicts (``{"w": (d_in, d_out), "b": (d_out,)}``,
``{"table": (vocab, d)}``) and the same float32 islands (norms and rotary
rotation compute in float32 and cast back). Init functions draw from an
explicit ``torch.Generator`` and create the tensors on its device; they do
not give ``jax.random``'s numbers, so tests hand both packages the same
parameters through ``repro_torch.models.convert``. ``MeshCtx`` is the
mesh context threaded through the models: with no mesh every method is the
identity; over a ``DeviceMesh`` it places DTensor activations as the
reference's sharding constraints do. ``mrope`` builds
qwen2-vl's multimodal rotary tables, which ``apply_rope`` applies.
``layer_norm`` and the GELU MLP are public layers of the reference that no
model of either package calls (Whisper's blocks use ``rms_norm`` and the
SwiGLU ``mlp``, as the reference's do).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

__all__ = [
    "MeshCtx",
    "per_shard",
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


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    """Mesh context threaded through model code for activation sharding:
    the port of ``repro.models.layers.MeshCtx``.

    ``data_axes`` shard the batch dimension (("pod", "data") on the
    multi-pod mesh); ``tp_axis`` shards feature and head dimensions. A
    ``None`` mesh disables every constraint. Over a ``DeviceMesh`` the
    activations are DTensors and a constraint is a ``redistribute`` to the
    spec's placements: a Partial sum becomes a reduce-scatter or an
    all-reduce, a shard gathered an all-gather, as GSPMD resolves the
    reference's ``with_sharding_constraint``.

    The reference reads its distribution knobs from the model config; the
    port's config describes the architecture only, so two of them live
    here: ``moe_ep_mode`` (``cfg.moe_ep_mode``) and ``gather_weights``
    (``cfg.zero3_use_site_gather``: the model calls ``gather_params`` at
    every block). ``seq_sharded`` is ``cfg.sequence_parallel``.
    """

    mesh: Any = None  # torch.distributed.device_mesh.DeviceMesh or None
    data_axes: tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    seq_sharded: bool = False  # Megatron-style sequence parallelism between blocks
    moe_ep_mode: str = "a2a"   # "a2a" (seq-sharded dispatch) | "replicated"
    gather_weights: bool = False

    def axis_size(self, axes) -> int:
        if self.mesh is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        sizes = dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))
        size = 1
        for a in axes:
            size *= int(sizes[a])
        return size

    def scope(self):
        """A context in which plain tensors meeting DTensors count as
        replicated, as GSPMD takes a constant (``implicit_replication``;
        re-entrant: an inner scope leaves the outer one on). No-op without
        a mesh."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import implicit_replication

        if DTensor._op_dispatcher._allow_implicit_replication:
            return contextlib.nullcontext()
        return implicit_replication()

    def placements(self, shape, spec) -> tuple:
        """DTensor placements of ``spec`` (one entry a dimension: None, an
        axis name or a tuple of them) for a tensor of ``shape``; an entry
        whose mesh size does not divide its dimension is dropped
        (replicated), as the reference's ``shard`` drops it."""
        from torch.distributed.tensor import Replicate, Shard

        owner = {}
        for dim, entry in zip(range(len(shape)), spec):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            if shape[dim] % self.axis_size(axes) == 0:
                owner.update({a: dim for a in axes})
        return tuple(Shard(owner[name]) if name in owner else Replicate()
                     for name in self.mesh.mesh_dim_names)

    def as_dtensor(self, x: torch.Tensor):
        """``x`` as a DTensor on the mesh: a plain tensor is taken as the
        same value on every rank (``Replicate``), as GSPMD takes a constant."""
        from torch.distributed.tensor import DTensor, Replicate

        if isinstance(x, DTensor):
            return x
        return DTensor.from_local(x, self.mesh, [Replicate()] * self.mesh.ndim,
                                  run_check=False)

    def shard(self, x: torch.Tensor, *spec) -> torch.Tensor:
        """Redistribute ``x`` to ``spec``'s placements (``placements``).
        Like ``with_sharding_constraint``, whose transpose constrains the
        cotangent to the same sharding, the gradient is redistributed to
        them too on its way back (DTensor would otherwise pick the
        backward's layouts from whatever placements the gradient arrives
        in)."""
        if self.mesh is None:
            return x
        x = self.as_dtensor(x)
        return _Constrain.apply(x, self.mesh, self.placements(x.shape, spec))

    def shard_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, ...) activations: batch over the data axes; with sequence
        parallelism the sequence dimension also over the TP axis (the
        divisibility rule turns this off for decode)."""
        seq = self.tp_axis if self.seq_sharded else None
        return self.shard(x, self.data_axes, seq, *([None] * (x.ndim - 2)))

    def shard_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, F) activations: batch over the data axes, features over TP."""
        return self.shard(x, self.data_axes, *([None] * (x.ndim - 2)), self.tp_axis)

    def split_heads(self, t: torch.Tensor, heads: int) -> torch.Tensor:
        """(..., heads * D) -> (..., heads, D). Over a mesh whose TP axis
        does not divide ``heads`` (whisper-tiny's 6 heads, xLSTM's 4, on
        16 ranks) the feature dimension is first replicated over TP: an
        explicit ``Replicate`` the reference leaves to GSPMD, as DTensor
        cannot split a TP-sharded dimension into heads it does not divide."""
        if self.mesh is not None and heads % self.axis_size(self.tp_axis):
            t = self.shard(t, self.data_axes, *([None] * (t.ndim - 1)))
        return t.reshape(*t.shape[:-1], heads, t.shape[-1] // heads)

    def merge_heads(self, t: torch.Tensor) -> torch.Tensor:
        """(..., heads, D) -> (..., heads * D), the inverse of
        ``split_heads``: where TP does not divide the heads, the merged
        features are pinned replicated, so the gradient arriving sharded
        over them is gathered before the view splits it into heads."""
        out = t.reshape(*t.shape[:-2], t.shape[-2] * t.shape[-1])
        if self.mesh is not None and t.shape[-2] % self.axis_size(self.tp_axis):
            out = self.shard(out, self.data_axes, *([None] * (out.ndim - 1)))
        return out

    _OUT_PROJ = ("wo", "w_down", "w_out")

    def gather_params(self, p):
        """ZeRO-3 use-site gather of a block's 2-D weights: each is first
        placed (fsdp over its input dimension, TP over its output one;
        output projections the other way round), then all-gathered over the
        data axes, keeping the TP shard. Under autograd the gather's
        backward is a reduce-scatter of the weight's gradient. The router
        (consumed replicated by the MoE block) and the 3-D expert tensors
        pass through; so does a weight whose dimensions the axes do not
        divide, and everything without a mesh."""
        if self.mesh is None:
            return p
        fsdp_size = self.axis_size(self.data_axes)
        tp_size = self.axis_size(self.tp_axis)

        def gather(w, fsdp_dim, tp_dim):
            if w.shape[fsdp_dim] % fsdp_size or w.shape[tp_dim] % tp_size:
                return w
            spec = [None, None]
            spec[fsdp_dim], spec[tp_dim] = self.data_axes, self.tp_axis
            out = [None, None]
            out[tp_dim] = self.tp_axis
            w = self.shard(w, *spec)  # placed: a local slice where w is replicated
            # the all-gather over the data axes; DTensor's own backward of it
            # reduce-scatters the gradient back onto the shards
            return w.redistribute(self.mesh, self.placements(w.shape, out))

        def walk(node, name=""):
            if isinstance(node, dict):
                # the projection's name passes down to its "w" / "b" leaves
                return {k: walk(v, k if isinstance(v, dict) else (name or k))
                        for k, v in node.items()}
            if not isinstance(node, torch.Tensor) or node.ndim != 2 or name == "router":
                return node
            if any(name == t or name.startswith(t) for t in self._OUT_PROJ):
                return gather(node, fsdp_dim=1, tp_dim=0)
            return gather(node, fsdp_dim=0, tp_dim=1)

        return walk(p)


def per_shard(fn, x: torch.Tensor, dims: tuple = ()) -> torch.Tensor:
    """``fn(x)`` for an ``fn`` that keeps ``x``'s shape and mixes entries
    along ``dims`` only (none for an elementwise one: ``dims=()``).
    On a DTensor whose placements shard none of ``dims``, ``fn`` of each
    rank's shard (a pending sum first reduced), rewrapped with the same
    placements: the numbers of ``fn`` on one device, for functions DTensor
    has no sharding strategy for (``logsigmoid``'s and ``softplus``'s
    backward, ``roll`` in some releases)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(x, DTensor):
        return fn(x)
    dims = {d % x.ndim for d in dims}
    if any(isinstance(pl, Shard) and pl.dim % x.ndim in dims for pl in x.placements):
        raise ValueError(f"{fn} acts along a sharded dimension of {x.placements}")
    if any(isinstance(pl, Partial) for pl in x.placements):
        x = x.redistribute(x.device_mesh, [Replicate() if isinstance(pl, Partial) else pl
                                           for pl in x.placements])
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to ``placements``, and its gradient too."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        return x if tuple(x.placements) == placements else x.redistribute(mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g, None, None


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
        from torch.distributed.tensor import DTensor

        b = p["b"]
        if isinstance(y, DTensor):
            # Over a mesh: the product's pending sums reduced and the bias
            # replicated first (an explicit Replicate; PERF.md section 7):
            # DTensor releases differ on adding a sharded bias to a
            # partial sum, some refusing it.
            y, b = _settled(y), _settled(b, replicate=True)
        y = y + b
    return y


def _settled(t: torch.Tensor, replicate: bool = False) -> torch.Tensor:
    """A DTensor with its partial sums reduced (and, with ``replicate``,
    its shards gathered)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(t, DTensor):
        return t
    want = [Replicate() if replicate or isinstance(pl, Partial) else pl for pl in t.placements]
    return t if list(t.placements) == want else t.redistribute(t.device_mesh, want)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype) -> dict:
    """Gated SwiGLU MLP (llama-style)."""
    return {
        "w_gate": init_dense(gen, d_model, d_ff, dtype),
        "w_up": init_dense(gen, d_model, d_ff, dtype),
        "w_down": init_dense(gen, d_ff, d_model, dtype, scale=d_ff ** -0.5),
    }


def mlp(p: dict, x: torch.Tensor, ctx: MeshCtx = MeshCtx()) -> torch.Tensor:
    h = ctx.shard_features(F.silu(dense(p["w_gate"], x)) * dense(p["w_up"], x))
    return dense(p["w_down"], h)


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype) -> dict:
    """Plain GELU MLP with biases (Whisper/StarCoder2-style). No model of
    either package calls it."""
    return {
        "w_fc": init_dense(gen, d_model, d_ff, dtype, bias=True),
        "w_out": init_dense(gen, d_ff, d_model, dtype, bias=True, scale=d_ff ** -0.5),
    }


def gelu_mlp(p: dict, x: torch.Tensor, ctx: MeshCtx = MeshCtx()) -> torch.Tensor:
    """The tanh GELU (``jax.nn.gelu``'s default). No model of either package
    calls it."""
    h = ctx.shard_features(F.gelu(dense(p["w_fc"], x), approximate="tanh"))
    return dense(p["w_out"], h)


def init_embedding(gen: torch.Generator, vocab: int, d_model: int, dtype: torch.dtype) -> dict:
    return {"table": torch.randn(vocab, d_model, generator=gen, dtype=dtype,
                                 device=gen.device) * 0.02}


def embed_tokens(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the table (``F.embedding``: over a mesh DTensor's
    vocabulary-parallel lookup, where an index into a vocabulary-sharded
    table has no backward strategy)."""
    return F.embedding(tokens, p["table"])
