"""DeepSeek-V3 671B [arXiv:2412.19437; hf].

61 layers, d_model 7168, 128 heads, MLA (q_lora 1536, kv_lora 512,
rope 64, nope 128, v 128). First 3 layers dense FFN (18432); the rest are
MoE: 1 shared + 256 routed experts (d_ff 2048), top-8. MTP depth 1.
vocab 129280. The JAX config's optimizer-state dtype and FSDP setting are
training knobs the port leaves out. One 80 GB card holds the full width at
a cut depth (``chip_smoke.py`` serves its first 4 layers: the 3 dense ones
and one MoE layer); the MTP head's parameters are carried, not run.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,
    vocab_size=129_280,
    n_experts=256,
    n_shared_experts=1,
    top_k=8,
    moe_d_ff=2048,
    n_dense_layers=3,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    mtp_depth=1,
    rope_theta=1e4,
)
