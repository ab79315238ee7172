"""Mamba2-1.3B [arXiv:2405.21060] — attention-free SSD (state-space duality)."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                       # the Mamba2 block has no separate FFN
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, conv_width=4, chunk=256),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
