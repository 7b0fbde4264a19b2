"""Routed mixture-of-experts with gather-based dispatch and explicit
expert-parallel all-to-alls: the port of ``repro.models.moe``.

Without a mesh ``moe_block`` takes the reference's ``_moe_a2a(...,
ep=1)``, whose all-to-alls are then no-ops. Top-k routing with optional
shared experts (DeepSeek-V3: 1 shared + 256 routed, top-8; Granite: 32
routed, top-8).

* Routing (``_route``): softmax of the float32 router logits, the top k
  in descending order (the lower expert id first on a tie, as
  ``jax.lax.top_k``), gates renormalised over the k, and the Switch
  load-balance loss.
* Capacity: ``C = max(int(t * k / E * capacity_factor), 4)`` slots an
  expert, in Python floats on the host, t the tokens of the call
  (B * S). Slots fill in token-major order over the flattened (t, k)
  choices; a choice past its expert's C slots is dropped and adds
  nothing (the shared experts still see every token).
* Dispatch is a gather through a (E * C) slot table into an (E, C, d)
  buffer, the experts are three batched products (``torch.bmm``), and the
  combine gathers each choice's row and weighs it by its gate, cast to the
  token type first as the reference does.

Over a mesh (``ctx.mesh``) the block runs the reference's ``shard_map``
body on each rank's local token shard through ``local_map``, and picks
its route as the reference does:

* **full EP** (``a2a`` over the intra-pod ``data`` axis and the TP axis,
  where E divides their product and S the TP axis): experts shard over
  that group; dispatch and return are two all-to-alls over it;
* **TP-axis EP** (``a2a`` over TP alone, where E divides only TP): the
  same with the model axis as the group;
* **replicated EP** (``ctx.moe_ep_mode == "replicated"``, or S not
  divisible by TP, as a decode step): tokens stay replicated over TP; each
  rank fills its own experts' slots and one all-reduce over TP combines
  the slot buffers;
* E not divisible by TP raises.

Capacity is computed from the rank's local token count, as the
reference's body computes it, so a mesh drops other choices than one
device does. The aux loss is averaged over every mesh axis the tokens
vary over. Collectives are ``torch.distributed._functional_collectives``
calls (``dist.collectives``, which the step analyser counts); their
gradients follow ``shard_map``'s: an all-to-all's is the reverse
all-to-all, the combining all-reduce passes its gradient through, and a
replicated operand meeting rank-varying work (``pvary``) has its gradient
all-reduced, where JAX's transpose of the implicit ``pvary`` puts its
``psum``. A batch that the
data ranks do not divide (the reference hands it to GSPMD whole) is
replicated on every rank explicitly and computed there. None of these
steps is a Pallas kernel in the reference; they are torch ops here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives as coll
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MeshCtx, init_mlp, mlp

__all__ = ["capacity", "init_moe", "moe_block", "moe_route"]


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    """Router (float32, as in the reference), stacked expert weights
    (E, d, f) / (E, f, d), and the shared experts as one wide MLP."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    dev = gen.device

    def randn(*shape, dt=dtype):
        return torch.randn(*shape, generator=gen, dtype=dt, device=dev)

    p = {
        "router": {"w": randn(d, E, dt=torch.float32) * d ** -0.5},
        "experts": {
            "w_gate": randn(E, d, f) * d ** -0.5,
            "w_up": randn(E, d, f) * d ** -0.5,
            "w_down": randn(E, f, d) * f ** -0.5,
        },
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, d, cfg.moe_d_ff * cfg.n_shared_experts, dtype)
    return p


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots an expert for a call over ``n_tokens`` tokens."""
    return max(int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 4)


def _route(tokens: torch.Tensor, router_w: torch.Tensor, k: int):
    """Top-k routing. tokens: (t, d) -> gates (t, k) float32, ids (t, k), aux loss."""
    t = tokens.shape[0]
    probs = torch.softmax(tokens.float() @ router_w, dim=-1)          # (t, E)
    E = probs.shape[-1]
    # A stable descending sort keeps the lower id first among equal
    # probabilities, as jax.lax.top_k does; torch.topk does not promise it.
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = gate_vals[:, :k], expert_ids[:, :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    me = probs.mean(dim=0)
    ce = torch.zeros(E, dtype=torch.float32, device=probs.device).index_add_(
        0, expert_ids.reshape(-1),
        torch.full((t * k,), 1.0 / (t * k), dtype=torch.float32, device=probs.device))
    aux = E * torch.sum(me * ce)
    return gate_vals, expert_ids, aux


def _slot_tables(expert_ids: torch.Tensor, E: int, capacity: int):
    """Slot bookkeeping. Returns (slot_token (E*C,), token_slot (t, k), keep (t, k)).

    ``slot_token`` maps each expert-capacity slot to its source token
    (sentinel t for an empty slot); ``token_slot`` maps each (token, choice)
    to its flat slot (sentinel E*C when dropped for overflow). A choice's
    place in its expert is the count of earlier choices of that expert in
    the flattened token-major (t, k) order.
    """
    t, k = expert_ids.shape
    flat = expert_ids.reshape(-1)
    # (E, t*k) one-hot, each expert's choices counted along its row: a scan
    # over the inner axis (a scan over the outer axis of a (t*k, E) one-hot
    # runs E threads deep on the card).
    onehot = (torch.arange(E, device=flat.device)[:, None] == flat[None, :]).int()
    pos = (onehot.cumsum(1, dtype=torch.int32).gather(0, flat[None, :])[0] - 1).reshape(t, k)
    keep = pos < capacity
    token_slot = torch.where(keep, expert_ids * capacity + pos, E * capacity)
    token_idx = torch.arange(t, device=expert_ids.device).expand(k, t).T
    slot_token = torch.full((E * capacity + 1,), t, dtype=torch.long, device=expert_ids.device)
    # Every kept choice has a slot of its own; the dropped ones all land on
    # the sentinel slot E*C, which is cut off.
    slot_token[token_slot.reshape(-1)] = token_idx.reshape(-1)
    return slot_token[:E * capacity], token_slot, keep


def _expert_ffn(experts: dict, buf: torch.Tensor) -> torch.Tensor:
    """buf: (E, C, d) -> (E, C, d), each expert's SiLU-gated MLP on its slots."""
    h = F.silu(torch.bmm(buf, experts["w_gate"])) * torch.bmm(buf, experts["w_up"])
    return torch.bmm(h, experts["w_down"])


def _dispatch(tokens: torch.Tensor, slot_token: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """Gather each slot's token into the (E, C, d) expert buffer; empty
    slots read the zero row past the last token."""
    tokens_pad = torch.cat([tokens, tokens.new_zeros(1, tokens.shape[1])])
    return tokens_pad[slot_token].reshape(E, C, tokens.shape[1])


def _combine(out_buf: torch.Tensor, token_slot: torch.Tensor, gates: torch.Tensor,
             keep: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(t, d): each token's kept choices' rows, weighted by their gates cast
    to the token type first; a dropped choice reads the zero row."""
    E, C, d = out_buf.shape
    flat = torch.cat([out_buf.reshape(E * C, d), out_buf.new_zeros(1, d)])
    per_choice = flat[token_slot]                                      # (t, k, d)
    w = (gates * keep).to(dtype)
    return torch.bmm(w[:, None, :], per_choice)[:, 0]


def _moe_local(tokens: torch.Tensor, router_w: torch.Tensor, experts: dict,
               cfg: ModelConfig):
    """The reference's ``_moe_a2a`` at ``ep=1``. tokens: (t, d) -> (t, d), aux."""
    E, C = cfg.n_experts, capacity(cfg, tokens.shape[0])
    gates, ids, aux = _route(tokens, router_w, cfg.top_k)
    slot_token, token_slot, keep = _slot_tables(ids, E, C)
    out_buf = _expert_ffn(experts, _dispatch(tokens, slot_token, E, C))
    return _combine(out_buf, token_slot, gates, keep, tokens.dtype), aux


def moe_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
              ctx: MeshCtx = MeshCtx()) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_loss). x: (B, S, d); ``ctx`` the mesh route
    (module docstring)."""
    B, S, d = x.shape
    if ctx.mesh is None:
        out, aux = _moe_local(x.reshape(B * S, d), p["router"]["w"], p["experts"], cfg)
        out = out.reshape(B, S, d)
    else:
        out, aux = _moe_mesh(p, x, cfg, ctx)
    if "shared" in p:
        out = out + mlp(p["shared"], x.reshape(B * S, d), ctx).reshape(B, S, d)
    return out, aux


# ---------------------------------------------------------------------------
# Expert parallelism over a mesh
# ---------------------------------------------------------------------------


def moe_route(ctx: MeshCtx, cfg: ModelConfig, B: int, S: int):
    """(mode, EP axes, EP size) of a (B, S) batch over ``ctx``'s mesh:
    ("local", (), 1) where the data ranks do not divide B, else the
    reference's choice among ``a2a`` over the full group, ``a2a`` over TP
    and ``replicated`` (module docstring). Raises where TP does not divide E."""
    if B % ctx.axis_size(ctx.data_axes):
        return "local", (), 1
    tp, E = ctx.axis_size(ctx.tp_axis), cfg.n_experts
    # The full group is the intra-pod "data" axis, where the mesh has one,
    # plus TP; never "pod": expert all-to-alls stay within a pod.
    full_axes = tuple(a for a in ("data",) if a in ctx.mesh.mesh_dim_names) + (ctx.tp_axis,)
    full = ctx.axis_size(full_axes)
    seq_shardable = S % tp == 0 and ctx.moe_ep_mode != "replicated"
    if seq_shardable and E % full == 0:
        return "a2a", full_axes, full
    if seq_shardable and E % tp == 0:
        return "a2a", (ctx.tp_axis,), tp
    if E % tp == 0:
        return "replicated", (ctx.tp_axis,), tp
    raise ValueError(f"n_experts ({E}) must divide the TP axis ({tp})")


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """(ep, ...) -> (ep, ...): block i goes to rank i of the group, the
    blocks received stacked in rank order (``lax.all_to_all`` with
    ``split_axis = concat_axis = 0``, not tiled). Differentiable: the
    gradient is the reverse all-to-all."""
    from torch.distributed import _functional_collectives as funcol

    out = funcol.all_to_all_single_autograd(x.contiguous(), None, None, group)
    return funcol.wait_tensor(out)


def _moe_a2a(tokens, router_w, experts, cfg: ModelConfig, ep: int, group):
    """The reference's ``_moe_a2a`` on a rank's tokens (t_local, d);
    experts (E/ep, d, f) local. Dispatch and return are all-to-alls over
    ``group`` where ``ep`` > 1."""
    t, d = tokens.shape
    E = cfg.n_experts
    E_local, C = E // ep, capacity(cfg, t)
    gates, ids, aux = _route(tokens, router_w, cfg.top_k)
    slot_token, token_slot, keep = _slot_tables(ids, E, C)
    buf = _dispatch(tokens, slot_token, E, C)
    if ep > 1:
        # every rank keeps its E_local experts' slots from every peer
        buf = _all_to_all(buf.reshape(ep, E_local, C, d), group)
        buf = buf.transpose(0, 1).reshape(E_local, ep * C, d)
    out_buf = _expert_ffn(experts, buf)
    if ep > 1:
        out_buf = out_buf.reshape(E_local, ep, C, d).transpose(0, 1)
        out_buf = _all_to_all(out_buf, group).reshape(E, C, d)
    return _combine(out_buf, token_slot, gates, keep, tokens.dtype), aux


def _moe_replicated_ep(tokens, router_w, experts, cfg: ModelConfig, tp: int, rank: int,
                       pvary, psum):
    """The reference's ``_moe_replicated_ep``: every TP rank routes the
    same tokens, fills only its local experts' slots, and one all-reduce
    over TP combines the slot buffers."""
    t, d = tokens.shape
    E = cfg.n_experts
    E_local, C = E // tp, capacity(cfg, t)
    gates, ids, aux = _route(tokens, router_w, cfg.top_k)
    slot_token, token_slot, keep = _slot_tables(ids, E, C)
    lo = rank * E_local * C
    local_slots = slot_token[lo:lo + E_local * C]
    buf = _dispatch(pvary(tokens), local_slots, E_local, C)
    out_buf = _expert_ffn(experts, buf)
    flat = torch.cat([out_buf.new_zeros(lo, d), out_buf.reshape(E_local * C, d),
                      out_buf.new_zeros(E * C - lo - E_local * C, d)])
    flat = psum(flat).reshape(E, C, d)
    return _combine(flat, token_slot, gates, keep, tokens.dtype), aux


def _moe_mesh(p: dict, x: torch.Tensor, cfg: ModelConfig, ctx: MeshCtx):
    """``moe_block``'s mesh route: (out DTensor (B, S, d), aux DTensor)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    B, S, d = x.shape
    mesh, names = ctx.mesh, ctx.mesh.mesh_dim_names
    mode, ep_axes, ep = moe_route(ctx, cfg, B, S)
    rep = [Replicate() for _ in names]  # local_map's placements are lists
    if mode == "local":
        # Explicit Replicate (the reference leaves this batch to GSPMD):
        # every rank computes the whole block on the whole batch.
        tok_pl, w_pl, vary = rep, rep, ()
    else:
        seq = ctx.tp_axis if mode == "a2a" else None
        tok_pl = list(ctx.placements(x.shape, (ctx.data_axes, seq, None)))
        w_pl = list(ctx.placements(p["experts"]["w_gate"].shape, (ep_axes, None, None)))
        vary = tuple(ctx.data_axes) + ((ctx.tp_axis,) if mode == "a2a" else ())
    exp_vary = tuple(a for a in vary if a not in ep_axes)
    tp = ctx.axis_size(ctx.tp_axis)
    rank = mesh.get_local_rank(ctx.tp_axis) if mode == "replicated" else 0

    def body(xs, router_w, w_gate, w_up, w_down):
        b, s, _ = xs.shape
        flat = xs.reshape(b * s, d)
        router_w = coll.pvary(router_w, mesh, vary)
        experts = {k: coll.pvary(w, mesh, exp_vary)
                   for k, w in (("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down))}
        if mode == "replicated":
            out, aux = _moe_replicated_ep(
                flat, router_w, experts, cfg, tp, rank,
                pvary=lambda t: coll.pvary(t, mesh, (ctx.tp_axis,)),
                psum=lambda t: coll.psum(t, mesh, (ctx.tp_axis,)))
        else:
            out, aux = _moe_a2a(flat, router_w, experts, cfg, ep,
                                coll.group(mesh, ep_axes) if ep > 1 else None)
        # aux averaged over every axis the tokens vary over
        for a in names:
            if a in vary:
                aux = coll.psum(aux, mesh, (a,)) / ctx.axis_size(a)
        return out.reshape(b, s, d), aux

    run = local_map(body, out_placements=(tok_pl, rep),
                    in_placements=(tok_pl, rep, w_pl, w_pl, w_pl),
                    device_mesh=mesh, redistribute_inputs=True)
    e = p["experts"]
    return run(ctx.as_dtensor(x), ctx.as_dtensor(p["router"]["w"]),
               *(ctx.as_dtensor(e[k]) for k in ("w_gate", "w_up", "w_down")))
