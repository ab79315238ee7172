"""Chameleon-34B [arXiv:2405.09818] — early-fusion VLM: VQ image tokens share
the text vocabulary, so the backbone is a dense decoder with QK-norm.
The VQ-VAE image tokenizer is the stubbed frontend (input_specs provides
token ids that may be text or image codes)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
    source="arXiv:2405.09818",
    tie_embeddings=False,
)
