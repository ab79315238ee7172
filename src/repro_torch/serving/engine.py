"""Serving: prefill and decode steps, sampling, the dense cache's
shape, batch axes and padding, and greedy generation.

A port of ``repro.serving.engine``.  PyTorch runs eagerly, so the steps
are plain functions (the JAX package jits them).  Greedy decoding is
exact argmax; temperature sampling is the JAX package's
``jax.random.categorical`` draw (``repro_torch.prng``) for the same key.

Dense cache layout (per attention layer, stacked over periods as the
prefill returns it): k/v (n_periods, B, S, K, hd) + slot_pos
(n_periods, B, S), an MLA layer's latents ckv (n_periods, B, S, r) and
krope (n_periods, B, S, rr) in place of k/v, a prefix layer's without
the period dim, and a Whisper decoder layer's cross-attention K/V of the
encoder output, ck/cv (n_periods, B, encoder_len, K, hd), written once
by the prefill (``pad_cache`` leaves them as they are); a windowed layer
keeps a ring of its last W
positions (slot = pos % W) once the prompt passes the window, so its
decode state is O(W).  ``cache_abstract`` gives the shapes of a ready
cache by a prefill on the ``meta`` device (the counterpart of
``jax.eval_shape``): nothing is allocated.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import prng
from repro_torch.configs.base import ModelConfig
from repro_torch.models.param import flatten_defs
from repro_torch.models.runtime import Runtime
from repro_torch.models.transformer import forward, model_defs

NEG_INF = -2.0e38


def make_prefill_step(cfg: ModelConfig, rt: Runtime):
    """``encoder_embeds`` (B, encoder_len, d), an encoder-decoder's frame
    embeddings; ``last_pos`` (B,), optional: per-row prompt-end position
    for bucket-padded batched prefill (see transformer.forward)."""
    def prefill(params, tokens, encoder_embeds=None, last_pos=None):
        return forward(params, cfg, rt, tokens, mode="prefill",
                       last_pos=last_pos, encoder_embeds=encoder_embeds)
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
    """One decode step: (params, cache, tokens (B,1), pos (B,)[, key])
    -> (next_token (B,), logits (B,V), cache).  The cache, dense or
    paged, is written in place.  ``temperature == 0`` is greedy argmax
    and ignores the key."""
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


META = torch.device("meta")


def cache_abstract(cfg: ModelConfig, B: int, S: int) -> Dict[str, torch.Tensor]:
    """The flat prefill cache of B sequences of length S as ``meta``
    tensors (shape and dtype, no storage): a prefill of ``model_defs``
    on the meta device, which allocates nothing and draws no weights;
    an encoder-decoder's with (B, encoder_len, d) fp32 frame embeddings,
    as the JAX package's."""
    params = {k: torch.empty(d.shape, dtype=d.dtype, device=META)
              for k, d in flatten_defs(model_defs(cfg)).items()}
    tokens = torch.empty((B, S), dtype=torch.int32, device=META)
    enc = (torch.empty((B, cfg.encoder_len, cfg.d_model), dtype=torch.float32,
                       device=META) if cfg.is_encoder_decoder else None)
    _, cache = forward(params, cfg, Runtime(device=META), tokens,
                       mode="prefill", encoder_embeds=enc)
    return cache


def cache_batch_axes(cfg: ModelConfig, S: int = 4) -> Dict[str, int]:
    """Each cache leaf's request (batch) axis: the one axis whose size
    changes between the abstract caches of 2 and 3 sequences (a stacked
    period dim of size 1 is never mistaken for it)."""
    a2, a3 = cache_abstract(cfg, 2, S), cache_abstract(cfg, 3, S)
    axes = {}
    for name, l2 in a2.items():
        diffs = [i for i, (d2, d3) in enumerate(zip(l2.shape, a3[name].shape))
                 if d2 != d3]
        assert len(diffs) == 1, (name, l2.shape, a3[name].shape)
        axes[name] = diffs[0]
    return axes


# sequence axis counted from the end: leaves may lead with the stacked
# period dim; k/v (..., S, K, hd), MLA's ckv/krope (..., S, r), slot_pos
# (..., S).  The cross cache (ck/cv, the encoder's length) and Mamba's
# fixed-size state are not grown.
SEQ_AXIS_FROM_END = {"k": 3, "v": 3, "ckv": 2, "krope": 2, "slot_pos": 1}


def pad_cache(cache: Dict[str, torch.Tensor], extra: int) -> Dict[str, torch.Tensor]:
    """A dense cache grown by ``extra`` decode slots: zeros, slot_pos -1
    (never valid).  Raises ``ValueError`` on a rotated ring (a prompt
    past a layer's window; a slot_pos row that does not start at 0):
    decode would then write slot pos % (W + extra) into a ring laid out
    by pos % W, over entries still inside the window.  Decode a rotated
    ring unpadded: with every layer windowed it is the whole state."""
    for name, leaf in cache.items():
        if name.endswith(".slot_pos") and bool((leaf[..., 0] != 0).any()):
            raise ValueError(f"pad_cache: {name} is a rotated ring (prompt "
                             f"past the window); decode it without padding")
    out = {}
    for name, leaf in cache.items():
        base = name.rsplit(".", 1)[-1]
        if base not in SEQ_AXIS_FROM_END:
            out[name] = leaf
            continue
        ax = leaf.dim() - SEQ_AXIS_FROM_END[base]
        shape = leaf.shape[:ax] + (extra,) + leaf.shape[ax + 1:]
        fill = torch.full(shape, -1 if base == "slot_pos" else 0,
                          dtype=leaf.dtype, device=leaf.device)
        out[name] = torch.cat([leaf, fill], dim=ax)
    return out


def greedy_generate(cfg: ModelConfig, rt: Runtime, params, prompt,
                    max_new: int, encoder_embeds=None) -> torch.Tensor:
    """Batched greedy decoding on the dense cache: prompt (B, S0) int32
    on ``rt.device`` -> (B, max_new) int32.  The prompt must fit every
    window (``pad_cache`` raises on a rotated ring).  An encoder-decoder
    takes its (B, encoder_len, d) ``encoder_embeds``: the prefill encodes
    them once and caches each layer's cross K/V."""
    B, S0 = prompt.shape
    logits, cache = make_prefill_step(cfg, rt)(params, prompt, encoder_embeds)
    cache = pad_cache(cache, max_new)
    step = make_serve_step(cfg, rt)
    tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
    out = [tok]
    pos = torch.full((B,), S0, dtype=torch.int32, device=prompt.device)
    for _ in range(max_new - 1):
        tok, _, cache = step(params, cache, tok[:, None], pos)
        out.append(tok)
        pos = pos + 1
    return torch.stack(out, dim=1)
