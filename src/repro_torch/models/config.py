"""Model configuration: one dataclass describing every assigned architecture.

The port's own copy of ``repro.models.config`` (pure Python). It keeps the
fields that describe an architecture, with the same names and defaults, so
a configuration means the same in both packages. The TPU package's
distribution and training knobs (``remat``, ``sequence_parallel``, the FSDP
and expert-parallel modes, ``opt_state_dtype``, ``attention_impl``) are left
out: nothing in the port reads them. ``capacity_factor`` stays: it sets how
many tokens an expert takes, and so which tokens a MoE layer drops.
``repro_torch/configs/<arch>.py`` instantiate it with published
hyper-parameters; reduced variants (``cfg.reduced()``) drive CPU tests.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES"]

BlockKind = Literal["attn", "local_attn", "rglru", "mlstm", "slstm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm

    # trunk
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads

    # block layout: tuple of BlockKind, length n_layers; () -> all "attn"
    block_pattern: tuple[str, ...] = ()
    local_window: int = 0        # for local_attn blocks
    lru_width: int = 0           # RG-LRU recurrence width (0 -> d_model)
    conv_width: int = 4          # temporal conv width in recurrent blocks

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_dense_layers: int = 0      # leading dense-FFN layers (DeepSeek style)
    capacity_factor: float = 1.25

    # MLA (DeepSeek latent attention)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # multi-token prediction (DeepSeek MTP)
    mtp_depth: int = 0

    # encoder-decoder (Whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 0         # precomputed frame embeddings (frontend stub)

    # modality stub: inputs are embeddings, not token ids (audio/vlm frontends)
    embedding_inputs: bool = False

    # flavor knobs
    qkv_bias: bool = False
    mrope_sections: tuple[int, ...] = ()   # M-RoPE (t, h, w) section dims
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    def __post_init__(self) -> None:
        if self.block_pattern and len(self.block_pattern) != self.n_layers:
            raise ValueError(
                f"{self.name}: block_pattern length {len(self.block_pattern)} "
                f"!= n_layers {self.n_layers}"
            )

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a 512 multiple so embeddings/logits shard over a
        16-way TP axis (Whisper 51865, Granite 49155 are otherwise unshardable
        and replicate the lm_head + full logits on every device)."""
        return -(-self.vocab_size // 512) * 512

    @property
    def resolved_block_pattern(self) -> tuple[str, ...]:
        return self.block_pattern or ("attn",) * self.n_layers

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_sub_quadratic(self) -> bool:
        """True iff per-token decode state is O(1) in history (SSM/hybrid)."""
        kinds = set(self.resolved_block_pattern)
        return kinds.issubset({"rglru", "mlstm", "slstm", "local_attn"})

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        n_layers = min(self.n_layers, 2 if not self.block_pattern else
                       min(len(_pattern_period(self.resolved_block_pattern)) + 1, 4))
        pattern = self.resolved_block_pattern[:n_layers] if self.block_pattern else ()
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            block_pattern=pattern,
            local_window=min(self.local_window, 32) if self.local_window else 0,
            lru_width=64 if self.lru_width else 0,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=32 if self.moe_d_ff else 0,
            n_dense_layers=min(self.n_dense_layers, 1),
            q_lora_rank=32 if self.q_lora_rank else 0,
            kv_lora_rank=16 if self.kv_lora_rank else 0,
            qk_rope_dim=8 if self.qk_rope_dim else 0,
            qk_nope_dim=8 if self.qk_nope_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 32) if self.encoder_seq else 0,
            mrope_sections=(2, 3, 3) if self.mrope_sections else (),  # sums to 16/2
            mtp_depth=min(self.mtp_depth, 1),
            dtype="float32",
            param_dtype="float32",
        )


def _pattern_period(pattern: tuple[str, ...]) -> tuple[str, ...]:
    """Smallest repeating prefix of a block pattern (for reduced configs)."""
    n = len(pattern)
    for p in range(1, n + 1):
        if all(pattern[i] == pattern[i % p] for i in range(n)):
            return pattern[:p]
    return pattern


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """An assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524288, global_batch=1, kind="decode"),
}
