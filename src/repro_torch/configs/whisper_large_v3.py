"""Whisper-large-v3 [arXiv:2212.04356] — encoder-decoder audio backbone.
The mel-spectrogram + conv feature extractor is a stub: input_specs()
provides precomputed (B, 1500, 1280) frame embeddings.  32 encoder +
32 decoder layers; decoder has causal self-attn + cross-attn.
long_500k is skipped (see DESIGN.md §6): a 1500-frame cross-attention
context has no 500k-token decode regime."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,                  # decoder layers
    n_encoder_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    act="gelu",
    is_encoder_decoder=True,
    encoder_len=1500,
    supports_long_context=False,
    pure_dp=True,                 # 20 heads don't divide model=16: train pure-DP
    rope_theta=10000.0,
    tie_embeddings=True,
    source="arXiv:2212.04356",
)
