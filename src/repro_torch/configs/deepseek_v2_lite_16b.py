"""DeepSeek-V2-Lite 16B [arXiv:2405.04434] — MLA + 64-expert MoE.

The assignment line lists "MoE 64e top-6" alongside "2 shared+160 routed";
the 160 duplicates the 236B row — we use 64 routed (the actual Lite model),
noted in DESIGN.md §6.
"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=0,
    d_ff=10944,                 # dense prefix-layer FFN
    vocab_size=102400,
    source="arXiv:2405.04434",
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                  n_dense_prefix=1, router_mode="softmax_topk"),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    tie_embeddings=False,
)
