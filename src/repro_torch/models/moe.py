"""Routed mixture-of-experts with gather-based dispatch, on one device.

The port of ``repro.models.moe`` for the route ``moe_block`` takes without
a mesh: ``_moe_a2a(..., ep=1)``, whose all-to-alls are then no-ops. Top-k
routing with optional shared experts (DeepSeek-V3: 1 shared + 256 routed,
top-8; Granite: 32 routed, top-8).

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

The expert-parallel routes (``shard_map`` over a mesh, ``moe_ep_mode``)
come with the multi-card tooling (ROADMAP A15). None of these steps is a
Pallas kernel in the reference; they are torch ops here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_mlp, mlp

__all__ = ["capacity", "init_moe", "moe_block"]


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


def moe_block(p: dict, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_loss). x: (B, S, d)."""
    B, S, d = x.shape
    out, aux = _moe_local(x.reshape(B * S, d), p["router"]["w"], p["experts"], cfg)
    out = out.reshape(B, S, d)
    if "shared" in p:
        out = out + mlp(p["shared"], x.reshape(B * S, d)).reshape(B, S, d)
    return out, aux
