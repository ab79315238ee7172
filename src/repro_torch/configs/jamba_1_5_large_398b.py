"""Jamba-1.5-Large 398B [arXiv:2403.19887] — hybrid Mamba+attention (1:7
interleave) with 16-expert top-2 MoE every other layer."""
from repro_torch.configs.base import MoEConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    attn_every=8,                 # 1 attention layer per 8 (1:7)
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, conv_width=4, chunk=256),
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=24576, n_shared=0,
                  moe_every=2, router_mode="topk_softmax"),
    # attention layers use a sliding window only in the long-context variant
    long_context_window=4096,
    tie_embeddings=False,
    # 398B fp32 state (12 B/param = 4.8 TB) exceeds one pod's 4 TB HBM:
    # store params/grads bf16, momentum fp32 (8 B/param) — DESIGN.md §4
    param_dtype="bfloat16",
    source="arXiv:2403.19887",
)
