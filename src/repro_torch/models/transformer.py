"""Model assembly for the dense decoder stacks, built from the layers.

A port of ``repro.models.transformer``: ``model_defs``, ``block_apply``
(attention plus dense FFN) and ``forward`` in ``train``, ``prefill``
and ``decode`` modes.  The JAX package scans the stacked layer period
with ``lax.scan``; here a Python loop walks the stacked leading dim,
split once with ``unbind`` so that the backward pass stacks each leaf's
gradient in one piece.  Per-block remat (``Runtime.remat``) is
``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``; its
sqrt-remat grouping of periods is not ported.  MoE, MLA, SSM and
encoder-decoder stacks are not ported yet and raise
``NotImplementedError``.

Parameters are the flat ``{dotted.path: Tensor}`` dict of
``models.param`` ("blocks.L0.attn.wq" has shape (n_periods, d, H, hd)).
Caches are flat dicts too: prefill returns the dense
"blocks.L{i}.attn.{k,v,slot_pos}" stacked over periods (a windowed
layer's a ring of its last W positions once the prompt passes the
window).  Decode takes either that dense cache (``serving.engine``'s
``pad_cache`` grows it) or the paged "blocks.L{i}.attn.{kp,vp,bt}"
(``serving.paged_cache``), told apart by their keys, writes each
period's entries in place through views of the stacked leaves, and
returns the same dict.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig, layer_pattern
from repro_torch.models import layers
from repro_torch.models.param import ParamDef, map_defs, stack
from repro_torch.models.runtime import Runtime

MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")


def check_supported(cfg: ModelConfig) -> None:
    for what, present in (("MoE", cfg.moe is not None),
                          ("MLA", cfg.mla is not None),
                          ("SSM", cfg.ssm is not None),
                          ("encoder-decoder", cfg.is_encoder_decoder)):
        if present:
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported yet (ROADMAP.md Queue A, "
                f"'Rest of the arch zoo')")


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def block_defs(cfg: ModelConfig, spec: LayerSpec):
    return {"attn_norm": layers.rmsnorm_defs(cfg.d_model),
            "attn": layers.attention_defs(cfg),
            "ffn_norm": layers.rmsnorm_defs(cfg.d_model),
            "ffn": layers.mlp_defs(cfg, cfg.d_ff)}


def model_defs(cfg: ModelConfig):
    check_supported(cfg)
    _, period, n_periods = layer_pattern(cfg)
    defs = {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab_table", "embed"),
                          "embed", scale=0.02),
        "final_norm": layers.rmsnorm_defs(cfg.d_model),
        "blocks": stack({f"L{i}": block_defs(cfg, s)
                         for i, s in enumerate(period)}, n_periods),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                   ("embed", "vocab"), scale=0.02)
    if cfg.param_dtype != "float32":
        dt = getattr(torch, cfg.param_dtype)
        defs = map_defs(lambda d: d._replace(dtype=dt), defs)
    return defs


def cast_for_compute(params: Dict[str, torch.Tensor],
                     cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """A params dict whose matmul weights are cast once to the compute
    dtype.  The JAX package casts them at every use
    (``p["wq"].astype(cdt)``); casting once gives the same bits without
    re-reading the fp32 weights on every decode step.  Norm scales and
    the embedding stay as stored: the logits are an fp32 product with
    the embedding, and the token gather casts after the lookup."""
    cdt = getattr(torch, cfg.compute_dtype)
    return {k: v.to(cdt) if k.rsplit(".", 1)[-1] in MATMUL_LEAVES else v
            for k, v in params.items()}


def unembed_matrix(params):
    u = params.get("unembed")
    return u if u is not None else params["embed"].T


def _sub(p: Dict[str, torch.Tensor], name: str) -> Dict[str, torch.Tensor]:
    pre = name + "."
    return {k[len(pre):]: v for k, v in p.items() if k.startswith(pre)}


# ---------------------------------------------------------------------------
# one block
# ---------------------------------------------------------------------------

def block_apply(p, spec: LayerSpec, h, cfg: ModelConfig, rt: Runtime, *,
                pos, cache=None, build_cache: bool = True):
    """Returns (h, cache): the dense prefill cache of this layer (None
    without ``build_cache``), or the decode cache dict it was given,
    dense or paged (updated in place)."""
    xin = layers.rmsnorm(p["attn_norm.scale"], h, cfg.norm_eps)
    a, c = layers.gqa_attention(_sub(p, "attn"), xin, cfg,
                                local=(spec.mixer == "attn_local"), pos=pos,
                                cache=cache, paged_kernel=rt.paged_kernel,
                                build_cache=build_cache)
    h = h + a.to(h.dtype)
    xin = layers.rmsnorm(p["ffn_norm.scale"], h, cfg.norm_eps)
    h = h + layers.mlp(_sub(p, "ffn"), xin, cfg).to(h.dtype)
    return h, c


# ---------------------------------------------------------------------------
# full forward
# ---------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, rt: Runtime, tokens, *,
            mode: str, cache=None, pos=None, last_pos=None):
    """mode: "train" | "prefill" | "decode".

    train:   tokens (B,S)            -> (final hidden (B,S,d), None)
    prefill: tokens (B,S)            -> (logits (B,1,V), dense cache)
    decode:  tokens (B,1), pos (B,)  -> (logits (B,1,V), cache), the
             dense or paged cache it was given, updated in place

    ``last_pos`` (B,), prefill only: per-row position whose logits to
    return instead of the last one (bucket-padded batched prefill).
    Train mode returns the hidden states: the loss projects them onto
    the vocabulary in sequence chunks (``training.loss``).
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"forward mode {mode!r}")
    check_supported(cfg)
    _, period, n_periods = layer_pattern(cfg)
    B, S = tokens.shape
    cdt = getattr(torch, cfg.compute_dtype)

    h = params["embed"][tokens.long()].to(cdt)
    if cfg.embed_scale:
        # rounded to the compute dtype before the multiply, as in JAX
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=cdt, device=h.device)

    if mode == "decode":
        rope_pos = pos
    else:
        rope_pos = torch.arange(S, dtype=torch.int32,
                                device=tokens.device).expand(B, S)

    per_layer: Dict[str, list] = {}
    leaves = (("kp", "vp", "bt") if mode == "decode" and
              "blocks.L0.attn.kp" in cache else ("k", "v", "slot_pos"))
    stacked = {k: v.unbind(0) for k, v in params.items()
               if k.startswith("blocks.")}
    remat = rt.remat and mode == "train"
    for i in range(n_periods):
        for j, spec in enumerate(period):
            pre = f"blocks.L{j}."
            p = {k[len(pre):]: v[i] for k, v in stacked.items()
                 if k.startswith(pre)}
            c_in: Optional[dict] = None
            if mode == "decode":    # views: in-place writes reach the stack
                c_in = {n: cache[f"{pre}attn.{n}"][i] for n in leaves}
            if remat:   # per-block remat: one block's internals live in bwd
                h = checkpoint(lambda pp, hh, spec=spec: block_apply(
                    pp, spec, hh, cfg, rt, pos=rope_pos, build_cache=False)[0],
                    p, h, use_reentrant=False)
                continue
            h, c = block_apply(p, spec, h, cfg, rt, pos=rope_pos, cache=c_in,
                               build_cache=mode != "train")
            if mode == "prefill":
                for n, t in c.items():
                    per_layer.setdefault(f"{pre}attn.{n}", []).append(t)

    h = layers.rmsnorm(params["final_norm.scale"], h, cfg.norm_eps)
    if mode == "train":
        return h, None
    new_cache = cache if mode == "decode" else \
        {k: torch.stack(v) for k, v in per_layer.items()}
    if mode == "prefill":
        h = (h[:, -1:, :] if last_pos is None
             else h[torch.arange(B, device=h.device), last_pos.long()][:, None])
    logits = h.float() @ unembed_matrix(params).float()
    logits = layers.softcap(logits, cfg.final_softcap)
    return logits, new_cache
