"""Whisper-tiny [arXiv:2212.04356].

Encoder-decoder, 4+4 layers, d_model 384, 6 heads, d_ff 1536, vocab 51865.
The conv/mel frontend is a STUB, as in the JAX package: the encoder takes
precomputed frame embeddings (B, 1500, d_model), which ``serve_lm.serve``
draws at random from its seed.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51_865,
    is_encoder_decoder=True,
    encoder_layers=4,
    encoder_seq=1500,
    tie_embeddings=True,
)
