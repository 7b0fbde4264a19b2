"""Yi-9B [arXiv:2403.04652; hf] — llama-architecture GQA.

48 layers, d_model 4096, 32 heads (GQA kv=4), d_ff 11008, vocab 64000.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64_000,
    rope_theta=1e4,
)
