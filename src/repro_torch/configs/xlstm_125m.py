"""xLSTM-125M [arXiv:2405.04517].

12 blocks, d_model 768, 4 heads, vocab 50304, no separate FFN (d_ff 0):
alternating mLSTM (matrix memory) / sLSTM (scalar memory) blocks.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    block_pattern=tuple("mlstm" if i % 2 == 0 else "slstm" for i in range(12)),
    tie_embeddings=True,
)
