"""Serving steps: prefill, one paged decode step, and sampling.

A port of the paged-serving half of ``repro.serving.engine``.  PyTorch
runs eagerly, so the steps are plain functions (the JAX package jits
them).  Greedy decoding is exact argmax; temperature sampling is the
JAX package's ``jax.random.categorical`` draw (``repro_torch.prng``) for
the same key.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import prng
from repro_torch.configs.base import ModelConfig
from repro_torch.models.runtime import Runtime
from repro_torch.models.transformer import forward

NEG_INF = -2.0e38


def make_prefill_step(cfg: ModelConfig, rt: Runtime):
    """``last_pos`` (B,), optional: per-row prompt-end position for
    bucket-padded batched prefill (see transformer.forward)."""
    def prefill(params, tokens, last_pos=None):
        return forward(params, cfg, rt, tokens, mode="prefill",
                       last_pos=last_pos)
    return prefill


def sample_logits(logits, key: torch.Tensor, temperature: float,
                  top_k: int = 0):
    """Seeded temperature (optionally top-k truncated) sampling over
    (B, V) logits -> (B,) int32: argmax of the fp32 tempered logits plus
    Gumbel noise drawn from ``key``, as ``jax.random.categorical``."""
    # a device tensor divisor: PyTorch's CUDA division by a host scalar
    # multiplies by its reciprocal, which rounds differently
    t = torch.tensor(temperature, dtype=torch.float32, device=logits.device)
    l = logits.float() / t
    if top_k > 0:
        kth = torch.topk(l, top_k, dim=-1).values[..., -1:]
        l = torch.where(l < kth, NEG_INF, l)
    return prng.categorical(key, l).to(torch.int32)


def make_serve_step(cfg: ModelConfig, rt: Runtime, *,
                    temperature: float = 0.0, top_k: int = 0):
    """One decode step: (params, paged cache, tokens (B,1), pos (B,)[,
    key]) -> (next_token (B,), logits (B,V), cache).  The cache's pools
    are written in place.  ``temperature == 0`` is greedy argmax and
    ignores the key."""
    def serve_step(params, cache, tokens, pos,
                   key: Optional[torch.Tensor] = None):
        logits, new_cache = forward(params, cfg, rt, tokens, mode="decode",
                                    cache=cache, pos=pos)
        last = logits[:, -1, :]
        if temperature == 0.0:
            nxt = torch.argmax(last, dim=-1).to(torch.int32)
        else:
            nxt = sample_logits(last, key, temperature, top_k)
        return nxt, last, new_cache
    return serve_step
