"""Qwen2-VL-72B [arXiv:2409.12191; hf] — transformer backbone only.

80 layers, d_model 8192, 64 heads (GQA kv=8), d_ff 29568, vocab 152064,
M-RoPE (temporal/height/width sections). The vision patch front end is a
stub, as in the JAX package: the caller supplies patch embeddings
(``batch["embeds"]``) and the M-RoPE position streams
(``batch["mrope_positions"]``).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152_064,
    qkv_bias=True,
    mrope_sections=(16, 24, 24),  # pairs: sums to head_dim/2 = 64
    rope_theta=1e6,
    embedding_inputs=True,
)
