"""DeepSeek-V2 236B [arXiv:2405.04434] — MoE with Multi-head Latent Attention."""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=0,
    d_ff=12288,                 # dense prefix-layer FFN (V2: 12288)
    vocab_size=102400,
    source="arXiv:2405.04434",
    moe=MoEConfig(n_experts=160, top_k=6, d_expert=1536, n_shared=2,
                  n_dense_prefix=1, router_mode="softmax_topk"),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    tie_embeddings=False,
)
