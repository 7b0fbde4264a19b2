"""StarCoder2-7B [arXiv:2402.19173; hf].

32 layers, d_model 4608, 36 heads (GQA kv=4), d_ff 18432, vocab 49152,
RoPE. (The released model uses sliding-window attention 4096; the assigned
config is exercised as full attention — see DESIGN.md shape-skip notes.)
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49_152,
    qkv_bias=True,
    rope_theta=1e5,
)
