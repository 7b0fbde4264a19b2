"""Roofline terms on H100 constants, and model-FLOPs accounting.

The port of ``repro.roofline``:

* ``param_counts`` and ``model_flops``: pure arithmetic on a
  ``ModelConfig`` (and a ``ShapeConfig``), with the reference's order of
  sums, so that both packages give the same floats. The serving planner
  (``repro_torch.sched.stage_model``) costs its stages with them.
* ``H100_CONSTANTS`` and ``roofline_terms``: the reference's three per-step
  terms (compute, memory, collective, in seconds per device) on the
  constants of one H100 SXM, taken from ``sched.fleet.H100_SXM`` so that
  the port holds them once. ``ici_bw`` keeps the reference's name: here it
  is one NVLink link's rate, as in ``ChipSpec``.
* ``collective_bytes_of(fn, *args, **kwargs)``: the keys of the
  reference's ``collective_bytes_from_hlo``, from a run of ``fn`` under
  ``step_analysis.analyze_step`` (eager PyTorch has no HLO text to parse).

The reference's TPU constants have no counterpart here.
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.sched.fleet import H100_SXM

__all__ = ["H100_CONSTANTS", "collective_bytes_of", "model_flops", "param_counts",
           "roofline_terms"]

H100_CONSTANTS = {
    "peak_flops": H100_SXM.peak_flops,   # bf16 FLOP/s per card, dense
    "hbm_bw": H100_SXM.hbm_bw,           # bytes/s per card
    "ici_bw": H100_SXM.ici_bw,           # bytes/s per NVLink link
}


def collective_bytes_of(fn, *args, **kwargs) -> dict:
    """Collective payload bytes per device of one call ``fn(*args,
    **kwargs)``, with its matmul FLOPs and touched bytes (see
    ``step_analysis.analyze_step``): the keys of the reference's
    ``collective_bytes_from_hlo``."""
    from repro_torch.step_analysis import analyze_step

    c = analyze_step(fn, *args, **kwargs)
    return {
        "total": c.collective_bytes,
        "by_kind": c.by_kind,
        "counts": c.collective_counts,
        "matmul_flops": c.matmul_flops,
        "touched_bytes": c.touched_bytes,
    }


def roofline_terms(
    flops_per_dev: float,
    bytes_per_dev: float,
    coll_bytes_per_dev: float,
    constants: dict = H100_CONSTANTS,
) -> dict:
    """The three per-step roofline terms, in seconds (per device)."""
    return {
        "compute": flops_per_dev / constants["peak_flops"],
        "memory": bytes_per_dev / constants["hbm_bw"],
        "collective": coll_bytes_per_dev / constants["ici_bw"],
    }


def param_counts(cfg: ModelConfig) -> dict:
    """Analytic parameter counts: total and active-per-token."""
    d, L = cfg.d_model, cfg.n_layers
    hd = cfg.resolved_head_dim
    embed = cfg.vocab_size * d
    head = 0 if cfg.tie_embeddings else cfg.vocab_size * d

    per_layer_total = 0.0
    per_layer_active = 0.0
    for i, kind in enumerate(cfg.resolved_block_pattern):
        if kind in ("attn", "local_attn"):
            if cfg.use_mla:
                a = (d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.n_heads *
                     (cfg.qk_nope_dim + cfg.qk_rope_dim)
                     + d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
                     + cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim)
                     + cfg.n_heads * cfg.v_head_dim * d)
            else:
                a = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd \
                    + cfg.n_heads * hd * d
            moe_layer = cfg.is_moe and i >= cfg.n_dense_layers
            if moe_layer:
                expert = 3 * d * cfg.moe_d_ff
                total_ffn = cfg.n_experts * expert + d * cfg.n_experts  # + router
                active_ffn = cfg.top_k * expert
                if cfg.n_shared_experts:
                    shared = 3 * d * cfg.moe_d_ff * cfg.n_shared_experts
                    total_ffn += shared
                    active_ffn += shared
            else:
                total_ffn = active_ffn = 3 * d * cfg.d_ff
            per_layer_total += a + total_ffn
            per_layer_active += a + active_ffn
        elif kind == "rglru":
            w = cfg.lru_width or d
            a = 2 * d * w + 2 * w * w + w * d + cfg.conv_width * w
            ffn = 3 * d * cfg.d_ff if cfg.d_ff else 0
            per_layer_total += a + ffn
            per_layer_active += a + ffn
        elif kind == "mlstm":
            du = 2 * d
            a = 2 * d * du + 3 * du * du + du * 2 * cfg.n_heads + du * d
            per_layer_total += a
            per_layer_active += a
        elif kind == "slstm":
            a = 6 * d * d
            per_layer_total += a
            per_layer_active += a

    enc = 0
    if cfg.is_encoder_decoder:
        enc = cfg.encoder_layers * (4 * d * cfg.n_heads * hd + 3 * d * cfg.d_ff
                                    + 4 * d * cfg.n_heads * hd)
    total = embed + head + per_layer_total + enc
    active = embed + head + per_layer_active + enc
    return {"total": total, "active": active}


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE); D = tokens this step.

    Decode steps process global_batch tokens; train/prefill process
    global_batch x seq_len. Embedding params are excluded from N per the
    usual convention (table lookups are not matmul FLOPs).
    """
    counts = param_counts(cfg)
    n_active = counts["active"] - cfg.vocab_size * cfg.d_model * (
        1 if cfg.tie_embeddings else 2
    )
    # keep the lm-head matmul (it is real compute): add back one head's worth
    n_active += cfg.vocab_size * cfg.d_model
    tokens = shape.global_batch * (1 if shape.is_decode else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * max(n_active, 0) * tokens
