"""Model assembly: the decoder-only stacks and the Whisper
encoder-decoder, built from the layers.

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
``jax.checkpoint``; a stack of 12 or more periods also runs them in
checkpointed groups of about sqrt(n) periods (``_remat_group``), as
the JAX package does.

Whisper (``cfg.is_encoder_decoder``): LayerNorms with a bias, an
ungated GELU MLP with biases, and an ``encoder`` subtree, a stack of
bidirectional attention + MLP layers over (B, encoder_len, d) frame
embeddings plus a sinusoid (the audio frontend is a stub, as in the
JAX package; its self-attention still applies RoPE, as the reference's
does).  Every decoder layer adds a cross-attention to the encoder's
output (no RoPE, no mask) between its self-attention and its MLP.

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
kinds, keyed by each layer's mixer.  A Whisper decoder layer's cache
adds its cross-attention's K/V of the encoder output,
"blocks.L{i}.cross.{ck,cv}" (n_periods, B, encoder_len, K, hd), written
once by the prefill and read by every decode step.  Decode
takes either that dense cache (``serving.engine``'s ``pad_cache`` grows
it) or the paged one, "{kp,vp,bt}" / MLA "{ckvp,kropep,bt}"
(``serving.paged_cache``), told apart by their keys, writes each
period's entries in place through views of the stacked leaves, and
returns the same dict.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig, layer_pattern
from repro_torch.models import layers, mamba, moe
from repro_torch.models.param import ParamDef, map_defs, stack
from repro_torch.models.runtime import Runtime

# matmul weights (and Mamba's conv, Whisper's MLP biases), cast once to
# the compute dtype (``cast_for_compute``); MoE's router (routed from fp32
# logits), the norm scales and biases (kv_norm, q_norm, Mamba's norm) and
# Mamba's A_log, D and dt_bias stay as stored, bf16 in jamba's tree, and
# are cast to fp32 at their use
MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "wg", "wu", "wd", "w1", "b1", "w2",
                 "b2", "wkv_a", "wk_b", "wv_b", "wq_a", "wq_b",
                 "wz", "wx", "wB", "wC", "wdt", "out_proj", "conv_w", "conv_b")


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def mixer_name(spec: LayerSpec) -> str:
    """The block's mixer subtree (and cache) name: "attn" or "mamba"."""
    return "attn" if spec.mixer in ("attn", "attn_local") else "mamba"


def block_defs(cfg: ModelConfig, spec: LayerSpec, with_cross: bool = False):
    norm = layers.norm_defs(cfg)
    if mixer_name(spec) == "attn":
        d = {"attn_norm": norm, "attn": layers.attention_defs(cfg)}
    else:
        d = {"mixer_norm": norm, "mamba": mamba.mamba_defs(cfg)}
    if with_cross:
        d["cross_norm"] = norm
        d["cross"] = layers.attention_defs(cfg, cross=True)
    if spec.ffn != "none":
        d["ffn_norm"] = norm
    if spec.ffn == "moe":
        d["moe"] = moe.moe_defs(cfg)
    elif spec.ffn == "dense":
        # Whisper's MLP is the ungated two-matrix one
        d["ffn"] = layers.mlp_defs(cfg, cfg.d_ff,
                                   gated=not cfg.is_encoder_decoder)
    return d


ENCODER_SPEC = LayerSpec("attn", "dense")


def model_defs(cfg: ModelConfig):
    prefix, period, n_periods = layer_pattern(cfg)
    cross = cfg.is_encoder_decoder
    defs = {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab_table", "embed"),
                          "embed", scale=0.02),
        "final_norm": layers.norm_defs(cfg),
    }
    if prefix:
        defs["prefix"] = {f"P{i}": block_defs(cfg, s, cross)
                          for i, s in enumerate(prefix)}
    defs["blocks"] = stack({f"L{i}": block_defs(cfg, s, cross)
                            for i, s in enumerate(period)}, n_periods)
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                   ("embed", "vocab"), scale=0.02)
    if cfg.is_encoder_decoder:
        defs["encoder"] = {
            "blocks": stack({"L0": block_defs(cfg, ENCODER_SPEC)},
                            cfg.n_encoder_layers),
            "final_norm": layers.norm_defs(cfg),
        }
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


def _norm(cfg: ModelConfig, p, name: str, x):
    """``layers.apply_norm`` on the norm ``name`` of the flat dict ``p``."""
    sub = {k: p[f"{name}.{k}"] for k in ("scale", "bias") if f"{name}.{k}" in p}
    return layers.apply_norm(cfg, sub, x)


# ---------------------------------------------------------------------------
# Whisper: the encoder and the cross-attention
# ---------------------------------------------------------------------------

@lru_cache(maxsize=8)
def _sinusoid(T: int, d: int) -> torch.Tensor:
    """(T, d) fp32 position table, [sin | cos] concatenated as in the JAX
    package.  Computed once on the host and copied to the device at each
    use, so the card and the CPU add the same bits."""
    pos = torch.arange(T, dtype=torch.float32)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32)[None, :]
    ang = pos / (10000.0 ** (2 * i / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _encoder_layer(p, h, cfg: ModelConfig, pos):
    xin = _norm(cfg, p, "attn_norm", h)
    a, _ = layers.gqa_attention(_sub(p, "attn"), xin, cfg, local=False,
                                pos=pos, causal=False, build_cache=False)
    h = h + a.to(h.dtype)
    xin = _norm(cfg, p, "ffn_norm", h)
    return h + layers.mlp(_sub(p, "ffn"), xin, cfg).to(h.dtype)


def encode(params, cfg: ModelConfig, rt: Runtime, encoder_embeds, *,
           remat: bool = False):
    """The stub-frontend encoder: (B, T, d) frame embeddings -> (B, T, d)
    in the compute dtype.  ``remat``: each layer under
    ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint`` of
    its scan body)."""
    h = encoder_embeds.to(getattr(torch, cfg.compute_dtype))
    T = h.shape[1]
    h = h + _sinusoid(T, cfg.d_model).to(h.device, h.dtype)
    pos = torch.arange(T, dtype=torch.int32, device=h.device)[None]
    pre = "encoder.blocks.L0."
    stacked = {k[len(pre):]: v.unbind(0) for k, v in params.items()
               if k.startswith(pre)}
    for i in range(cfg.n_encoder_layers):
        p = {k: v[i] for k, v in stacked.items()}
        if remat:
            h = checkpoint(lambda pp, x: _encoder_layer(pp, x, cfg, pos), p, h,
                           use_reentrant=False)
        else:
            h = _encoder_layer(p, h, cfg, pos)
    return _norm(cfg, params, "encoder.final_norm", h)


def _cross_kv(p, enc, cfg: ModelConfig):
    cdt = getattr(torch, cfg.compute_dtype)
    ec = enc.to(cdt)
    return (layers._proj_in(ec, p["wk"].to(cdt)),
            layers._proj_in(ec, p["wv"].to(cdt)))


def _cross_attend(p, x, cfg: ModelConfig, ck, cv):
    """Attention of x (B, S, d) to the encoder's K/V: no RoPE, no mask,
    no softcap, scale hd^-0.5."""
    cdt = getattr(torch, cfg.compute_dtype)
    q = layers._proj_in(x.to(cdt), p["wq"].to(cdt))
    o = layers._sdpa_seq(q, ck.to(cdt), cv.to(cdt), False, 0, 0.0,
                         cfg.resolved_head_dim ** -0.5, cfg.sdpa_bf16)
    return layers._proj_out(o, p["wo"].to(cdt))


# ---------------------------------------------------------------------------
# one block
# ---------------------------------------------------------------------------

def block_apply(p, spec: LayerSpec, h, cfg: ModelConfig, rt: Runtime, *,
                pos, cache=None, build_cache: bool = True, encoder_out=None):
    """``cache`` (decode): this layer's entries keyed below the block,
    "attn.k", "cross.ck", ...  Returns (h, cache, aux): the dense prefill
    cache of this layer, keyed alike (None without ``build_cache``), or
    the decode cache it was given, dense or paged (updated in place);
    and the MoE load-balance loss (a zero fp32 scalar for a dense FFN or
    none).  The cross-attention runs on ``encoder_out`` (train, prefill)
    or on the cache's "cross.{ck,cv}" (decode), and is skipped with
    neither, as in the JAX package."""
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    mixer = mixer_name(spec)
    c_in = _sub(cache, mixer) if cache is not None else None
    if mixer == "mamba":
        xin = _norm(cfg, p, "mixer_norm", h)
        a, c = mamba.mamba_block(_sub(p, "mamba"), xin, cfg, cache=c_in,
                                 build_cache=build_cache)
    else:
        xin = _norm(cfg, p, "attn_norm", h)
        local = spec.mixer == "attn_local"
        if cfg.mla is not None:
            a, c = layers.mla_attention(_sub(p, "attn"), xin, cfg, local=local,
                                        pos=pos, cache=c_in,
                                        build_cache=build_cache)
        else:
            a, c = layers.gqa_attention(_sub(p, "attn"), xin, cfg, local=local,
                                        pos=pos, cache=c_in,
                                        paged_kernel=rt.paged_kernel,
                                        build_cache=build_cache)
    h = h + a.to(h.dtype)
    out = None
    if cache is not None:
        out = cache
    elif c is not None:
        out = {f"{mixer}.{n}": t for n, t in c.items()}
    cross_cached = cache is not None and "cross.ck" in cache
    if "cross_norm.scale" in p and (encoder_out is not None or cross_cached):
        xin = _norm(cfg, p, "cross_norm", h)
        if cross_cached:
            ck, cv = cache["cross.ck"], cache["cross.cv"]
        else:
            ck, cv = _cross_kv(_sub(p, "cross"), encoder_out, cfg)
            if out is not None:
                out.update({"cross.ck": ck, "cross.cv": cv})
        h = h + _cross_attend(_sub(p, "cross"), xin, cfg, ck, cv).to(h.dtype)
    if spec.ffn == "none":              # a pure SSM block is its mixer
        return h, out, zero
    xin = _norm(cfg, p, "ffn_norm", h)
    if spec.ffn == "moe":
        y, aux = moe.moe_apply(_sub(p, "moe"), xin, cfg)
    else:
        y = layers.mlp(_sub(p, "ffn"), xin, cfg)
        aux = zero
    h = h + y.to(h.dtype)
    return h, out, aux


# ---------------------------------------------------------------------------
# full forward
# ---------------------------------------------------------------------------

def _remat_group(n_periods: int) -> int:
    """Group size for sqrt-remat (the JAX package's): ~sqrt(n), only
    for deep stacks."""
    if n_periods < 12:
        return 1
    import math
    return max(2, round(math.sqrt(n_periods)))


def forward(params, cfg: ModelConfig, rt: Runtime, tokens, *,
            mode: str, cache=None, pos=None, last_pos=None,
            encoder_embeds=None):
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
    ``encoder_embeds`` (B, encoder_len, d), an encoder-decoder's train
    and prefill modes: encoded once, the decoder's cross-attention reads
    the result (decode reads the prefill's cross cache instead).
    Train mode returns the hidden states: the loss projects them onto
    the vocabulary in sequence chunks (``training.loss``).
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"forward mode {mode!r}")
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
    encoder_out = None
    if cfg.is_encoder_decoder and encoder_embeds is not None:
        encoder_out = encode(params, cfg, rt, encoder_embeds, remat=remat)
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    new_cache: Dict[str, torch.Tensor] = {}

    def run(p, spec, hh, c_in):
        if remat:   # per-block remat: one block's internals live in bwd
            hh, aux = checkpoint(lambda pp, x, enc, spec=spec: block_apply(
                pp, spec, x, cfg, rt, pos=rope_pos, build_cache=False,
                encoder_out=enc)[::2], p, hh, encoder_out, use_reentrant=False)
            return hh, None, aux
        return block_apply(p, spec, hh, cfg, rt, pos=rope_pos, cache=c_in,
                           build_cache=mode != "train", encoder_out=encoder_out)

    # --- unrolled prefix layers ---
    for i, spec in enumerate(prefix):
        pre = f"prefix.P{i}"
        c_in = _sub(cache, pre) if mode == "decode" else None
        h, c, aux = run(_sub(params, pre), spec, h, c_in)
        aux_total = aux_total + aux
        if mode == "prefill":
            new_cache.update({f"{pre}.{n}": t for n, t in c.items()})

    # --- the stacked periods ---
    per_layer: Dict[str, list] = {}
    layer_caches = ({j: _sub(cache, f"blocks.L{j}") for j in range(len(period))}
                    if mode == "decode" else {})
    stacked = {k: v.unbind(0) for k, v in params.items()
               if k.startswith("blocks.")}

    def period_params(i):
        return [{k[len(pre):]: v[i] for k, v in stacked.items()
                 if k.startswith(pre)}
                for pre in (f"blocks.L{j}." for j in range(len(period)))]

    def run_periods(ps, hh, aux_acc):
        for p_period in ps:
            for spec, p in zip(period, p_period):
                hh, _, aux = run(p, spec, hh, None)
                aux_acc = aux_acc + aux
        return hh, aux_acc

    # sqrt-remat: groups of `group` periods, each group checkpointed
    # around its blocks' own checkpoints, so backward keeps one h a group
    # (and recomputes a group's forward once more); the remainder
    # periods run ungrouped, as in the JAX package
    group = _remat_group(n_periods) if remat else 1
    n_grouped = n_periods - n_periods % group if group > 1 else 0
    for g0 in range(0, n_grouped, group):
        h, aux_total = checkpoint(
            run_periods, [period_params(i) for i in range(g0, g0 + group)],
            h, aux_total, use_reentrant=False)
    for i in range(n_grouped, n_periods):
        for j, (spec, p) in enumerate(zip(period, period_params(i))):
            pre = f"blocks.L{j}."
            c_in: Optional[dict] = None
            if mode == "decode":    # views: in-place writes reach the stack
                c_in = {n: t[i] for n, t in layer_caches[j].items()}
            h, c, aux = run(p, spec, h, c_in)
            aux_total = aux_total + aux
            if mode == "prefill":
                for n, t in c.items():
                    per_layer.setdefault(pre + n, []).append(t)

    h = _norm(cfg, params, "final_norm", h)
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
