"""Granite-3.0-1B-A400M base [hf:ibm-granite/granite-3.0-1b-a400m-base].

24 layers, d_model 1024, 16 heads (GQA kv=8), 32 experts top-8 with
per-expert d_ff 512, vocab 49155.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=0,
    vocab_size=49_155,
    n_experts=32,
    top_k=8,
    moe_d_ff=512,
    rope_theta=1e4,
    tie_embeddings=True,
)
