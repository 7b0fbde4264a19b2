"""RecurrentGemma-2B [arXiv:2402.19427; hf:google/recurrentgemma-2b].

26 blocks, d_model 2560, 10 heads (MQA kv=1, head_dim 256), d_ff 7680,
vocab 256000. Griffin layout: 1 local-attention block per 2 RG-LRU
recurrent blocks (window 2048); lru width = d_model.
"""

from repro_torch.models.config import ModelConfig

_PATTERN = []
for i in range(26):
    _PATTERN.append("local_attn" if i % 3 == 2 else "rglru")

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    block_pattern=tuple(_PATTERN),
    local_window=2048,
    lru_width=2560,
    conv_width=4,
    rope_theta=1e4,
    tie_embeddings=True,
)
