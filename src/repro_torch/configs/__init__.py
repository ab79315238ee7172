"""Architecture registry: ``get_config(name)`` / ``ARCHS``.

The ten architecture configs are copied as data from
``repro.configs``; the port does not import the JAX package.
"""
from repro_torch.configs.base import (
    MLAConfig, MoEConfig, ModelConfig, SSMConfig, ShapeConfig, SHAPES,
    LayerSpec, layer_pattern, smoke_variant,
)

from repro_torch.configs.deepseek_v2_236b import CONFIG as _dsv2
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as _dsv2l
from repro_torch.configs.yi_9b import CONFIG as _yi
from repro_torch.configs.deepseek_7b import CONFIG as _ds7
from repro_torch.configs.gemma_2b import CONFIG as _g2b
from repro_torch.configs.gemma2_27b import CONFIG as _g27
from repro_torch.configs.chameleon_34b import CONFIG as _cham
from repro_torch.configs.whisper_large_v3 import CONFIG as _whis
from repro_torch.configs.mamba2_1_3b import CONFIG as _mamba
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as _jamba

ARCHS = {c.name: c for c in
         [_dsv2, _dsv2l, _yi, _ds7, _g2b, _g27, _cham, _whis, _mamba, _jamba]}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = [
    "ARCHS", "get_config", "ModelConfig", "MoEConfig", "MLAConfig",
    "SSMConfig", "ShapeConfig", "SHAPES", "LayerSpec", "layer_pattern",
    "smoke_variant",
]
