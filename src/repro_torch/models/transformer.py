"""Model assembly for the decoder-only stacks, built from the layers.

A port of ``repro.models.transformer``: ``model_defs``, ``block_apply``
(GQA or MLA attention, or a Mamba2 mixer (``models.mamba``), then a
dense or MoE FFN; a pure Mamba2 block is its mixer alone) and
``forward`` in ``train``, ``prefill`` and ``decode`` modes.  The jamba
hybrid mixes them in one period (``layer_pattern``: 8 layers, L4
attention, the rest Mamba2, MoE FFNs on the odd layers), every leaf
stored in bf16 and cast at its use.  The JAX package scans the
stacked layer period with ``lax.scan``; here a Python loop walks the
stacked leading dim, split once with ``unbind`` so that the backward
pass stacks each leaf's gradient in one piece.  Leading prefix layers
(DeepSeek-V2's dense first layer, ``layer_pattern``) are unrolled
before the periods and carry no stacked dim.  Per-block remat
(``Runtime.remat``) is ``torch.utils.checkpoint``, the JAX package's
``jax.checkpoint``; its sqrt-remat grouping of periods is not ported.
Encoder-decoder stacks are not ported yet and raise
``NotImplementedError``.

Parameters are the flat ``{dotted.path: Tensor}`` dict of
``models.param`` ("blocks.L0.attn.wq" has shape (n_periods, d, H, hd);
"prefix.P0.attn.wq" has none).  Caches are flat dicts too: prefill
returns each attention layer's dense cache, "blocks.L{i}.attn.{k,v,
slot_pos}" stacked over periods (MLA: "{ckv,krope,slot_pos}", the
latents only), "prefix.P{i}.attn.*" unstacked; a windowed layer keeps a
ring of its last W positions once the prompt passes the window.  A
Mamba2 layer's cache is its per-sequence state, "blocks.L{i}.mamba.conv"
(n_periods, B, W-1, conv_dim) and ".ssm" (n_periods, B, H, P, N), the
same in the dense and the paged cache; a hybrid's cache holds both
kinds, keyed by each layer's mixer.  Decode
takes either that dense cache (``serving.engine``'s ``pad_cache`` grows
it) or the paged one, "{kp,vp,bt}" / MLA "{ckvp,kropep,bt}"
(``serving.paged_cache``), told apart by their keys, writes each
period's entries in place through views of the stacked leaves, and
returns the same dict.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig, layer_pattern
from repro_torch.models import layers, mamba, moe
from repro_torch.models.param import ParamDef, map_defs, stack
from repro_torch.models.runtime import Runtime

# matmul weights (and Mamba's conv), cast once to the compute dtype
# (``cast_for_compute``); MoE's router (routed from fp32 logits), the norm
# scales (kv_norm, q_norm, Mamba's norm) and Mamba's A_log, D and dt_bias
# stay as stored, bf16 in jamba's tree, and are cast to fp32 at their use
MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "wg", "wu", "wd",
                 "wkv_a", "wk_b", "wv_b", "wq_a", "wq_b",
                 "wz", "wx", "wB", "wC", "wdt", "out_proj", "conv_w", "conv_b")


def check_supported(cfg: ModelConfig) -> None:
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder is not ported yet (ROADMAP.md "
            f"Queue A, 'Rest of the arch zoo')")


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def mixer_name(spec: LayerSpec) -> str:
    """The block's mixer subtree (and cache) name: "attn" or "mamba"."""
    return "attn" if spec.mixer in ("attn", "attn_local") else "mamba"


def block_defs(cfg: ModelConfig, spec: LayerSpec):
    if mixer_name(spec) == "attn":
        d = {"attn_norm": layers.rmsnorm_defs(cfg.d_model),
             "attn": layers.attention_defs(cfg)}
    else:
        d = {"mixer_norm": layers.rmsnorm_defs(cfg.d_model),
             "mamba": mamba.mamba_defs(cfg)}
    if spec.ffn != "none":
        d["ffn_norm"] = layers.rmsnorm_defs(cfg.d_model)
    if spec.ffn == "moe":
        d["moe"] = moe.moe_defs(cfg)
    elif spec.ffn == "dense":
        d["ffn"] = layers.mlp_defs(cfg, cfg.d_ff)
    return d


def model_defs(cfg: ModelConfig):
    check_supported(cfg)
    prefix, period, n_periods = layer_pattern(cfg)
    defs = {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab_table", "embed"),
                          "embed", scale=0.02),
        "final_norm": layers.rmsnorm_defs(cfg.d_model),
    }
    if prefix:
        defs["prefix"] = {f"P{i}": block_defs(cfg, s)
                          for i, s in enumerate(prefix)}
    defs["blocks"] = stack({f"L{i}": block_defs(cfg, s)
                            for i, s in enumerate(period)}, n_periods)
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
    cast = compute_cast(cfg)
    return {k: cast(k, v) for k, v in params.items()}


def compute_cast(cfg: ModelConfig):
    """``cast(path, tensor)``: the tensor in the compute dtype if the leaf
    is a matmul weight, else as it is.  ``materialize(..., cast=)`` applies
    it to each leaf as it is drawn, so the whole fp32 tree never exists."""
    cdt = getattr(torch, cfg.compute_dtype)

    def cast(path: str, t: torch.Tensor) -> torch.Tensor:
        return t.to(cdt) if path.rsplit(".", 1)[-1] in MATMUL_LEAVES else t
    return cast


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
    """Returns (h, cache, aux): the dense prefill cache of this layer
    (None without ``build_cache``), or the decode cache dict it was
    given, dense or paged (updated in place); and the MoE load-balance
    loss (a zero fp32 scalar for a dense FFN or none)."""
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    if mixer_name(spec) == "mamba":
        xin = layers.rmsnorm(p["mixer_norm.scale"], h, cfg.norm_eps)
        a, c = mamba.mamba_block(_sub(p, "mamba"), xin, cfg, cache=cache,
                                 build_cache=build_cache)
    else:
        xin = layers.rmsnorm(p["attn_norm.scale"], h, cfg.norm_eps)
        local = spec.mixer == "attn_local"
        if cfg.mla is not None:
            a, c = layers.mla_attention(_sub(p, "attn"), xin, cfg, local=local,
                                        pos=pos, cache=cache,
                                        build_cache=build_cache)
        else:
            a, c = layers.gqa_attention(_sub(p, "attn"), xin, cfg, local=local,
                                        pos=pos, cache=cache,
                                        paged_kernel=rt.paged_kernel,
                                        build_cache=build_cache)
    h = h + a.to(h.dtype)
    if spec.ffn == "none":              # a pure SSM block is its mixer
        return h, c, zero
    xin = layers.rmsnorm(p["ffn_norm.scale"], h, cfg.norm_eps)
    if spec.ffn == "moe":
        y, aux = moe.moe_apply(_sub(p, "moe"), xin, cfg)
    else:
        y = layers.mlp(_sub(p, "ffn"), xin, cfg)
        aux = zero
    h = h + y.to(h.dtype)
    return h, c, aux


# ---------------------------------------------------------------------------
# full forward
# ---------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, rt: Runtime, tokens, *,
            mode: str, cache=None, pos=None, last_pos=None):
    """mode: "train" | "prefill" | "decode".

    train:   tokens (B,S)            -> (final hidden (B,S,d), aux)
    prefill: tokens (B,S)            -> (logits (B,1,V), dense cache)
    decode:  tokens (B,1), pos (B,)  -> (logits (B,1,V), cache), the
             dense or paged cache it was given, updated in place

    ``aux`` is the sum of the MoE layers' load-balance losses, an fp32
    scalar (0 without MoE); the JAX package returns it in every mode,
    serving has no use for it, so only train mode returns it here.
    ``last_pos`` (B,), prefill only: per-row position whose logits to
    return instead of the last one (bucket-padded batched prefill).
    Train mode returns the hidden states: the loss projects them onto
    the vocabulary in sequence chunks (``training.loss``).
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"forward mode {mode!r}")
    check_supported(cfg)
    prefix, period, n_periods = layer_pattern(cfg)
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

    remat = rt.remat and mode == "train"
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    new_cache: Dict[str, torch.Tensor] = {}

    def run(p, spec, hh, c_in):
        if remat:   # per-block remat: one block's internals live in bwd
            hh, aux = checkpoint(lambda pp, x, spec=spec: block_apply(
                pp, spec, x, cfg, rt, pos=rope_pos, build_cache=False)[::2],
                p, hh, use_reentrant=False)
            return hh, None, aux
        return block_apply(p, spec, hh, cfg, rt, pos=rope_pos, cache=c_in,
                           build_cache=mode != "train")

    # --- unrolled prefix layers ---
    for i, spec in enumerate(prefix):
        pre = f"prefix.P{i}.{mixer_name(spec)}"
        c_in = _sub(cache, pre) if mode == "decode" else None
        h, c, aux = run(_sub(params, f"prefix.P{i}"), spec, h, c_in)
        aux_total = aux_total + aux
        if mode == "prefill":
            new_cache.update({f"{pre}.{n}": t for n, t in c.items()})

    # --- the stacked periods ---
    per_layer: Dict[str, list] = {}
    layer_caches = ({j: _sub(cache, f"blocks.L{j}.{mixer_name(spec)}")
                     for j, spec in enumerate(period)}
                    if mode == "decode" else {})
    stacked = {k: v.unbind(0) for k, v in params.items()
               if k.startswith("blocks.")}
    for i in range(n_periods):
        for j, spec in enumerate(period):
            pre = f"blocks.L{j}."
            p = {k[len(pre):]: v[i] for k, v in stacked.items()
                 if k.startswith(pre)}
            c_in: Optional[dict] = None
            if mode == "decode":    # views: in-place writes reach the stack
                c_in = {n: t[i] for n, t in layer_caches[j].items()}
            h, c, aux = run(p, spec, h, c_in)
            aux_total = aux_total + aux
            if mode == "prefill":
                for n, t in c.items():
                    per_layer.setdefault(f"{pre}{mixer_name(spec)}.{n}",
                                         []).append(t)

    h = layers.rmsnorm(params["final_norm.scale"], h, cfg.norm_eps)
    if mode == "train":
        return h, aux_total
    if mode == "decode":
        new_cache = cache
    else:
        new_cache.update({k: torch.stack(v) for k, v in per_layer.items()})
    if mode == "prefill":
        h = (h[:, -1:, :] if last_pos is None
             else h[torch.arange(B, device=h.device), last_pos.long()][:, None])
    logits = h.float() @ unembed_matrix(params).float()
    logits = layers.softcap(logits, cfg.final_softcap)
    return logits, new_cache
