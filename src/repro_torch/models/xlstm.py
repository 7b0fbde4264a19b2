"""xLSTM blocks, mLSTM (matrix memory) and sLSTM (scalar memory): the port
of ``repro.models.xlstm`` (arXiv:2405.04517).

mLSTM cell, per head with key/value dim D:

    C_t = f_t C_{t-1} + i_t (v_t k_t^T)        matrix memory (D, D)
    n_t = f_t n_{t-1} + i_t k_t                normalizer (D,)
    h_t = (C_t q_t) / max(|n_t^T q_t|, 1)

with the exponential input gate and the log-sigmoid forget gate
stabilised by the running max m_t = max(log f_t + m_{t-1}, log i_t).

A prompt runs the reference's chunkwise evaluation: ``S // 256`` chunks of
``S // (S // 256)`` tokens (one chunk below 256), a Python loop over the
chunks where the JAX package runs ``lax.scan``; the state carries from
chunk to chunk as ``C[v_dim, k_dim]``, ``n`` and ``m``. At S >= 256 that
is not a multiple of ``S // 256`` (513, say) the reference's reshape
fails; the port raises a ``ValueError`` there and does not pad. A decode
step (S == 1) is the one-token update.

sLSTM (a recurrence through h_{t-1} that is not diagonal) runs its whole
time loop in one launch of the hand-written ``kernels/slstm_scan`` kernel
on the card (the reference's ``lax.scan``; ``_slstm_scan`` dispatches), on
the CPU the plain loop of ``kernels/slstm_scan/ref.py``. Under autograd
(training) the same call goes through the kernel package's
``torch.autograd.Function``, whose backward is the hand-written
``slstm_scan_bwd`` kernels on the card (a loop and a rest pass in the
cluster layout) and their plain version on the CPU.

The mLSTM recurrence is eager torch ops. Both are float32 throughout, with
the reference's stabilisers and its -1e30 mask fill. Both blocks return a
new state only when one was passed in.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.kernels.slstm_scan import ops as slstm_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MeshCtx, dense, per_shard, init_dense, rms_norm

__all__ = [
    "MLSTMState",
    "SLSTMState",
    "init_mlstm_block",
    "mlstm_block",
    "init_mlstm_state",
    "init_slstm_block",
    "slstm_block",
    "init_slstm_state",
]

CHUNK = 256
_NEG = -1e30


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MLSTMState:
    C: torch.Tensor   # (B, H, D, D) float32, C[v_dim, k_dim]
    n: torch.Tensor   # (B, H, D) float32
    m: torch.Tensor   # (B, H) float32


def _mlstm_head_dim(cfg: ModelConfig) -> int:
    return (2 * cfg.d_model) // cfg.n_heads  # the cell runs at the up-projected width


def init_mlstm_state(batch: int, cfg: ModelConfig, dtype: torch.dtype | None = None,
                     device: str | torch.device = "cuda") -> MLSTMState:
    """Zero memory and normalizer, ``m`` at -1e30; float32 whatever ``dtype``."""
    dev = resolve_device(device)
    h, d = cfg.n_heads, _mlstm_head_dim(cfg)
    return MLSTMState(C=torch.zeros(batch, h, d, d, device=dev),
                      n=torch.zeros(batch, h, d, device=dev),
                      m=torch.full((batch, h), _NEG, device=dev))


def init_mlstm_block(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    d = cfg.d_model
    du = 2 * d
    return {
        "w_up": init_dense(gen, d, du, dtype),
        "w_gate": init_dense(gen, d, du, dtype),
        "wq": init_dense(gen, du, du, dtype),
        "wk": init_dense(gen, du, du, dtype),
        "wv": init_dense(gen, du, du, dtype),
        "w_if": init_dense(gen, du, 2 * cfg.n_heads, dtype, bias=True),
        "out_norm": torch.zeros(du, dtype=dtype, device=gen.device),
        "w_down": init_dense(gen, du, d, dtype, scale=du ** -0.5),
    }


def chunking(S: int) -> tuple[int, int]:
    """(chunks, tokens a chunk) of the reference's chunkwise evaluation;
    raises where its reshape fails."""
    nc = S // CHUNK if S >= CHUNK else 1
    chunk = S // nc
    if nc * chunk != S:
        raise ValueError(
            f"mLSTM prefill of S={S} tokens: the reference evaluates S // {CHUNK} = {nc} "
            f"chunks of S // {nc} = {chunk} tokens, so S >= {CHUNK} must be a multiple of "
            f"S // {CHUNK}")
    return nc, chunk


def _mlstm_chunk_parallel(q, k, v, log_i, log_f, state: MLSTMState):
    """Chunkwise evaluation. q/k/v: (B, H, S, D) float32; gates (B, H, S)
    float32. Returns (h (B, H, S, D), state at the end)."""
    B, H, S, D = q.shape
    nc, chunk = chunking(S)
    scale = D ** -0.5
    # Within-chunk cumulative log forget (inclusive) per position.
    cum_f = log_f.reshape(B, H, nc, chunk).cumsum(dim=-1)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=q.device).tril()
    C, n, m = state.C, state.n, state.m
    hs = []
    for c in range(nc):
        part = slice(c * chunk, (c + 1) * chunk)
        qc, kc, vc, lic = q[:, :, part], k[:, :, part], v[:, :, part], log_i[..., part]
        cfc = cum_f[:, :, c]
        total_f = cfc[..., -1]
        # The recurrence m_t = max(log f_t + m_{t-1}, log i_t) unrolls to
        # m_t = cfc[t] + max(m_prev, cummax_s(lic[s] - cfc[s])).
        src = lic - cfc
        m_t = cfc + torch.maximum(m[..., None], torch.cummax(src, dim=-1).values)
        m_new = total_f + torch.maximum(m, src.amax(dim=-1))

        # Decay D[t, s] = exp(cfc[t] - cfc[s] + lic[s] - m_t), masked to s <= t.
        dmat = cfc[..., :, None] - cfc[..., None, :] + lic[..., None, :]
        w = torch.exp(torch.where(causal, dmat - m_t[..., :, None], _NEG))
        scores = torch.einsum("bhtd,bhsd->bhts", qc, kc) * scale
        intra = torch.einsum("bhts,bhsd->bhtd", scores * w, vc)
        n_w = torch.einsum("bhts,bhsd->bhtd", w, kc)

        # The state entering the chunk, decayed per position.
        carry_scale = torch.exp(cfc + m[..., None] - m_t)
        inter = torch.einsum("bhtk,bhvk->bhtv", qc, C) * scale * carry_scale[..., None]
        n_tot = n_w + n[..., None, :] * carry_scale[..., None]
        denom = torch.einsum("bhtd,bhtd->bht", n_tot, qc * scale).abs().clamp_min(1.0)
        hs.append((intra + inter) / denom[..., None])

        # The state at the end of the chunk.
        scale_state = torch.exp(total_f + m - m_new)
        src_scale = torch.exp(total_f[..., None] - cfc + lic - m_new[..., None])
        C = C * scale_state[..., None, None] + torch.einsum("bhs,bhsd,bhse->bhde",
                                                            src_scale, vc, kc)
        n = n * scale_state[..., None] + torch.einsum("bhs,bhsd->bhd", src_scale, kc)
        m = m_new
    return torch.cat(hs, dim=2), MLSTMState(C=C, n=n, m=m)


def _mlstm_decode(q, k, v, log_i, log_f, state: MLSTMState):
    """One-token update. q/k/v: (B, H, 1, D) float32; gates (B, H, 1)."""
    D = q.shape[-1]
    q0, k0, v0, li, lf = q[:, :, 0], k[:, :, 0], v[:, :, 0], log_i[..., 0], log_f[..., 0]
    m_new = torch.maximum(lf + state.m, li)
    i_p = torch.exp(li - m_new)
    f_p = torch.exp(lf + state.m - m_new)
    C = state.C * f_p[..., None, None] + i_p[..., None, None] * (v0[..., :, None] * k0[..., None, :])
    n = state.n * f_p[..., None] + i_p[..., None] * k0
    num = torch.einsum("bhde,bhe->bhd", C, q0) * D ** -0.5
    den = (torch.einsum("bhd,bhd->bh", n, q0).abs() * D ** -0.5).clamp_min(1.0)
    return (num / den[..., None])[:, :, None, :], MLSTMState(C=C, n=n, m=m_new)


def _mlstm_local(ctx: MeshCtx, cell, q, k, v, log_i, log_f, st: MLSTMState):
    """The mLSTM recurrence (``cell``) over a mesh: on each rank's batch
    shard through ``local_map``, every head whole (xLSTM's 4 heads do not
    split over a TP axis of 16). No parameter enters it, so no gradient is
    pending across ranks."""
    from torch.distributed.tensor.experimental import local_map

    def pl(t):
        return list(ctx.placements(t.shape, (ctx.data_axes,) + (None,) * (t.ndim - 1)))

    args = (q, k, v, log_i, log_f, st.C, st.n, st.m)

    def body(q, k, v, log_i, log_f, C, n, m):
        h, out = cell(q, k, v, log_i, log_f, MLSTMState(C=C, n=n, m=m))
        return h, out.C, out.n, out.m

    run = local_map(body, out_placements=(pl(q), pl(st.C), pl(st.n), pl(st.m)),
                    in_placements=tuple(pl(t) for t in args), device_mesh=ctx.mesh,
                    redistribute_inputs=True)
    h, C, n, m = run(*(ctx.as_dtensor(t) for t in args))
    return h, MLSTMState(C=C, n=n, m=m)


def mlstm_block(
    p: dict,
    x: torch.Tensor,                 # (B, S, d)
    cfg: ModelConfig,
    state: MLSTMState | None = None,
    ctx: MeshCtx = MeshCtx(),
) -> tuple[torch.Tensor, MLSTMState | None]:
    B, S, _ = x.shape
    H = cfg.n_heads
    up = ctx.shard_features(dense(p["w_up"], x))
    gate = F.gelu(dense(p["w_gate"], x), approximate="tanh")  # jax.nn.gelu's default

    q, k, v = (ctx.split_heads(dense(p[w], up), H).transpose(1, 2).float()
               for w in ("wq", "wk", "wv"))
    gates = dense(p["w_if"], up).float()                       # (B, S, 2H)
    log_i = gates[..., :H].transpose(1, 2)                      # (B, H, S)
    log_f = per_shard(F.logsigmoid, gates[..., H:]).transpose(1, 2)
    st = state if state is not None else init_mlstm_state(B, cfg, device=x.device)

    cell = _mlstm_decode if S == 1 else _mlstm_chunk_parallel
    if ctx.mesh is None:
        h, new_state = cell(q, k, v, log_i, log_f, st)
    else:
        h, new_state = _mlstm_local(ctx, cell, q, k, v, log_i, log_f, st)

    h = ctx.merge_heads(h.transpose(1, 2)).to(x.dtype)
    h = ctx.shard_features(rms_norm(p["out_norm"], h, cfg.norm_eps) * gate)
    return dense(p["w_down"], h), (new_state if state is not None else None)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SLSTMState:
    c: torch.Tensor   # (B, d) float32
    n: torch.Tensor   # (B, d) float32
    h: torch.Tensor   # (B, d) float32
    m: torch.Tensor   # (B, d) float32


def init_slstm_state(batch: int, cfg: ModelConfig, dtype: torch.dtype | None = None,
                     device: str | torch.device = "cuda") -> SLSTMState:
    """Zero cell, normalizer and output, ``m`` at -1e30; float32."""
    dev = resolve_device(device)
    z = lambda: torch.zeros(batch, cfg.d_model, device=dev)  # noqa: E731
    return SLSTMState(c=z(), n=z(), h=z(), m=torch.full((batch, cfg.d_model), _NEG, device=dev))


def init_slstm_block(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    d = cfg.d_model
    return {
        "w_z": init_dense(gen, d, d, dtype, bias=True),
        "w_i": init_dense(gen, d, d, dtype, bias=True),
        "w_f": init_dense(gen, d, d, dtype, bias=True),
        "w_o": init_dense(gen, d, d, dtype, bias=True),
        # The recurrent (h_{t-1}) connection: the part that is not diagonal.
        "r_z": init_dense(gen, d, d, dtype),
        "w_out": init_dense(gen, d, d, dtype, scale=d ** -0.5),
    }


def _slstm_scan(zx, ix, fx, ox, rw, st: SLSTMState):
    """The time loop. Gate inputs (B, S, d) float32, ``rw`` (d, d) float32.
    Returns (h (B, S, d), state after the last step). Meta tensors: shapes
    only; otherwise ``slstm_ops.slstm_scan``: the kernel on CUDA tensors,
    the plain loop on CPU tensors, each with its backward under autograd."""
    if zx.device.type == "meta":
        # Shapes only (the dry-run, where a meta operation costs a Python
        # call): every step's product and update at once, the operations
        # the loop runs S times on (B, d) run once on (B, S, d); the
        # previous output stands in for h_{t-1}, whose values meta lacks.
        c, n, h, m = st.c, st.n, st.h, st.m
        log_f, o = per_shard(F.logsigmoid, fx), torch.sigmoid(ox)
        prev = torch.cat([h[:, None], zx[:, :-1]], dim=1)
        zt = torch.tanh(zx + prev @ rw)
        m_all = torch.maximum(log_f + m[:, None], ix)
        i_p, f_p = torch.exp(ix - m_all), torch.exp(log_f + m[:, None] - m_all)
        c_all, n_all = f_p * c[:, None] + i_p * zt, f_p * n[:, None] + i_p
        hs = o * c_all / n_all.clamp_min(1.0)
        return hs, SLSTMState(c=c_all[:, -1], n=n_all[:, -1], h=hs[:, -1], m=m_all[:, -1])
    hs, c, n, h, m = slstm_ops.slstm_scan(zx, ix, fx, ox, rw,
                                          *(t.contiguous() for t in (st.c, st.n, st.h, st.m)))
    return hs, SLSTMState(c=c, n=n, h=h, m=m)


def _slstm_scan_local(ctx: MeshCtx, zx, ix, fx, ox, rw, st: SLSTMState):
    """``_slstm_scan`` over a mesh: the time loop on each rank's batch
    shard through ``local_map``, the gates' features and the recurrent
    matrix whole on every rank (the recurrence mixes every feature each
    step); the loop then dispatches local operations, not DTensor ones (on
    the card the kernel, and under autograd its backward kernel)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    gate_pl = list(ctx.placements(zx.shape, (ctx.data_axes, None, None)))
    state_pl = list(ctx.placements(st.c.shape, (ctx.data_axes, None)))
    rep_pl = list(ctx.placements(rw.shape, (None, None)))

    def body(zx, ix, fx, ox, rw, c, n, h, m):
        hs, out = _slstm_scan(zx, ix, fx, ox, rw, SLSTMState(c=c, n=n, h=h, m=m))
        return hs, out.c, out.n, out.h, out.m

    # The recurrent matrix's gradient is each rank's sum over its own batch
    # shard: pending over the data axes.
    rw_grad = [Partial() if a in ctx.data_axes else Replicate()
               for a in ctx.mesh.mesh_dim_names]
    in_pl = (gate_pl,) * 4 + (rep_pl,) + (state_pl,) * 4
    run = local_map(body, out_placements=(gate_pl,) + (state_pl,) * 4, in_placements=in_pl,
                    in_grad_placements=in_pl[:4] + (rw_grad,) + in_pl[5:],
                    device_mesh=ctx.mesh, redistribute_inputs=True)
    hs, c, n, h, m = run(*(ctx.as_dtensor(t) for t in (zx, ix, fx, ox, rw, st.c, st.n, st.h,
                                                         st.m)))
    return hs, SLSTMState(c=c, n=n, h=h, m=m)


def slstm_block(
    p: dict,
    x: torch.Tensor,                 # (B, S, d)
    cfg: ModelConfig,
    state: SLSTMState | None = None,
    ctx: MeshCtx = MeshCtx(),
    train: bool = False,
) -> tuple[torch.Tensor, SLSTMState | None]:
    """``train``: the training route, which the model passes to every
    block; the sLSTM time loop takes the same call on both routes, and
    autograd differentiates it through the kernel's backward."""
    B = x.shape[0]
    zx, ix, fx, ox = (dense(p[w], x).float() for w in ("w_z", "w_i", "w_f", "w_o"))
    rw = p["r_z"]["w"].float()
    st = state if state is not None else init_slstm_state(B, cfg, device=x.device)
    if ctx.mesh is None:
        hs, new_state = _slstm_scan(zx, ix, fx, ox, rw, st)
    else:
        hs, new_state = _slstm_scan_local(ctx, zx, ix, fx, ox, rw, st)
    out = ctx.shard_tokens(hs.to(x.dtype))
    return dense(p["w_out"], out), (new_state if state is not None else None)
