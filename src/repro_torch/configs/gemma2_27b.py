"""Gemma2-27B [arXiv:2408.00118] — alternating local(4096)/global attention,
attention- and final-logit soft-capping, GeGLU."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    act="gelu",
    embed_scale=True,
    tie_embeddings=True,
    window=4096,
    local_global_period=2,
    attn_softcap=50.0,
    final_softcap=30.0,
    source="arXiv:2408.00118",
)
