"""Next-token cross-entropy, computed in sequence chunks so the
(B, S, vocab) logits tensor never materializes (vocab is up to 256k).

A port of ``repro.training.loss``.  Each chunk runs under
``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``): the
backward pass recomputes the chunk's logits instead of storing them.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers

CHUNK = 512


def _chunk_loss(h_c, unembed, t_c, m_c, cfg: ModelConfig):
    if cfg.logits_bf16:
        # bf16 inputs, f32 accumulation and output, and JAX's backward
        # (the JAX package's preferred_element_type=f32; ``bf16_dot``)
        logits = layers.bf16_dot(h_c.flatten(0, -2), unembed).unflatten(
            0, h_c.shape[:-1])
    else:
        logits = h_c.float() @ unembed.float()
    logits = layers.softcap(logits, cfg.final_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, t_c[..., None].long())[..., 0]
    ce = (lse - picked) * m_c
    return ce.sum(), m_c.sum()


def lm_loss(h, unembed, tokens, mask, cfg: ModelConfig):
    """h: (B,S,d) final hidden; tokens: (B,S) int; mask: (B,S) f32.

    Predicts tokens[:, t+1] from h[:, t]; the last position is masked out.
    Returns (mean loss over masked tokens, token count), both f32.
    """
    B, S, _ = h.shape
    targets = torch.roll(tokens, -1, dims=1)
    last = torch.ones((B, S), dtype=mask.dtype, device=mask.device)
    last[:, -1] = 0
    m = mask * last

    chunk = min(CHUNK, S)
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of {chunk}")
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, chunk):
        s, n = checkpoint(_chunk_loss, h[:, c0:c0 + chunk], unembed,
                          targets[:, c0:c0 + chunk], m[:, c0:c0 + chunk], cfg,
                          use_reentrant=False)
        tot = tot + s
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1.0), cnt
