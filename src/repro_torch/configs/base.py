"""Configuration dataclasses for models and input shapes.

A copy of ``repro.configs.base`` as pure dataclasses: the port keeps
its own so that it never imports the JAX package.  Every architecture
is a ``ModelConfig``; ``layer_pattern`` gives the stacked layer period
and ``smoke_variant`` the CPU-sized variant used by the tests.  The
JAX-only ``input_specs`` (ShapeDtypeStructs for the dry-run) is not
carried over.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence, Tuple



# ---------------------------------------------------------------------------
# sub-configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration (DeepSeek-V2 / Jamba style)."""
    n_experts: int                 # routed experts
    top_k: int
    d_expert: int                  # per-expert FFN hidden size
    n_shared: int = 0              # shared (always-on) experts
    moe_every: int = 1             # a MoE FFN every `moe_every` layers
    n_dense_prefix: int = 0        # leading layers with dense FFN instead
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2
    # 'softmax_topk': softmax over all experts then take top-k (DeepSeek-V2)
    # 'topk_softmax': top-k logits then softmax over them (Mixtral/Jamba)
    router_mode: str = "softmax_topk"


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0           # 0 = no query compression
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block configuration."""
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256               # SSD chunk length for the training scan
    ngroups: int = 1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    source: str = ""               # citation

    # FFN / attention details
    act: str = "silu"              # silu (SwiGLU) | gelu (GeGLU)
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    qk_norm: bool = False          # Chameleon-style QK RMSNorm
    attn_softcap: float = 0.0      # Gemma2 logit soft-capping (attention)
    final_softcap: float = 0.0     # Gemma2 final-logit soft-capping
    window: int = 0                # sliding window for *local* attn layers
    local_global_period: int = 0   # gemma2: alternate local/global attn
    embed_scale: bool = False      # gemma: scale embeddings by sqrt(d_model)
    tie_embeddings: bool = True

    # hybrid (jamba): one attention layer every `attn_every` layers
    attn_every: int = 0            # 0 -> attention everywhere (or pure SSM)

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_len: int = 1500        # precomputed frame embeddings (stub frontend)

    # long-context behaviour
    supports_long_context: bool = True   # whisper -> False (documented skip)
    long_context_window: int = 8192      # window applied by for_long_context()

    # distribution: small models whose head counts don't divide the model
    # axis (whisper: 20 heads on model=16) train as pure data parallelism —
    # the batch shards over (pod, data, model) and weights replicate on
    # "model" (see DESIGN.md §4 hardware-adaptation notes)
    pure_dp: bool = False

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # ---- beyond-paper performance knobs (§Perf; default = faithful
    # baseline numerics) ----
    sdpa_bf16: bool = False    # attention matmuls bf16-in/f32-accumulate (MXU native)
    logits_bf16: bool = False  # loss vocab projection bf16-in/f32-accumulate

    # ---------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def has_ssm_layers(self) -> bool:
        return self.ssm is not None

    @property
    def is_pure_ssm(self) -> bool:
        return self.ssm is not None and self.attn_every == 0

    def for_long_context(self) -> "ModelConfig":
        """Variant used for the long_500k shape: every full-attention layer
        becomes sliding-window (``long_context_window``) so decode is O(W).
        SSM layers are untouched (already O(1))."""
        if not self.supports_long_context:
            raise ValueError(f"{self.name} does not support long_500k (see DESIGN.md)")
        return replace(self, window=self.long_context_window,
                       local_global_period=0)  # all layers local

    def param_count(self) -> int:
        """Analytic total parameter count (embedding + blocks)."""
        return _param_count(self)

    def active_param_count(self) -> int:
        return _param_count(self, active_only=True)


# ---------------------------------------------------------------------------
# layer pattern: what the stacked period looks like
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LayerSpec:
    mixer: str          # "attn" | "attn_local" | "mamba"
    ffn: str            # "dense" | "moe" | "none"


def layer_pattern(cfg: ModelConfig) -> Tuple[Sequence[LayerSpec], Sequence[LayerSpec], int]:
    """Return (prefix_layers, period_layers, n_periods).

    The model = prefix layers (unrolled) + n_periods repetitions of the
    period (the port loops over the stacked leading dim, period unrolled
    inside the loop body).
    """
    def ffn_kind(layer_idx: int) -> str:
        if cfg.ssm is not None and cfg.attn_every == 0:
            return "none"  # pure mamba2: the block IS the mixer
        if cfg.moe is None:
            return "dense"
        if layer_idx < cfg.moe.n_dense_prefix:
            return "dense"
        if cfg.moe.moe_every > 1 and (layer_idx % cfg.moe.moe_every != 1):
            return "dense"
        return "moe"

    def mixer_kind(layer_idx: int) -> str:
        if cfg.ssm is not None:
            if cfg.attn_every == 0:
                return "mamba"
            # hybrid: one attn layer per attn_every, centred in the period
            return "attn" if (layer_idx % cfg.attn_every) == cfg.attn_every // 2 else "mamba"
        if cfg.local_global_period:
            return "attn_local" if (layer_idx % cfg.local_global_period) == 0 else "attn"
        if cfg.window:
            return "attn_local"
        return "attn"

    # period length: lcm of the structural periodicities present
    import math
    period = 1
    for p in (cfg.attn_every or 1,
              cfg.local_global_period or 1,
              (cfg.moe.moe_every if cfg.moe else 1) or 1):
        period = math.lcm(period, p)

    n_prefix = cfg.moe.n_dense_prefix if cfg.moe else 0
    body_layers = cfg.n_layers - n_prefix
    assert body_layers % period == 0, (
        f"{cfg.name}: {body_layers} body layers not divisible by period {period}")

    prefix = [LayerSpec(mixer_kind(i), ffn_kind(i)) for i in range(n_prefix)]
    period_specs = [LayerSpec(mixer_kind(n_prefix + i), ffn_kind(n_prefix + i))
                    for i in range(period)]
    return prefix, period_specs, body_layers // period


# ---------------------------------------------------------------------------
# analytic parameter count
# ---------------------------------------------------------------------------

def _attn_params(cfg: ModelConfig) -> int:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if cfg.mla is not None:
        m = cfg.mla
        qk_hd = m.qk_nope_dim + m.qk_rope_dim
        n = d * (m.kv_lora_rank + m.qk_rope_dim)                  # wkv_a
        n += m.kv_lora_rank * H * (m.qk_nope_dim + m.v_head_dim)  # wk_b, wv_b
        if m.q_lora_rank:
            n += d * m.q_lora_rank + m.q_lora_rank * H * qk_hd
        else:
            n += d * H * qk_hd
        n += H * m.v_head_dim * d                                 # wo
        return n
    return d * H * hd + 2 * d * K * hd + H * hd * d


def _ffn_dense_params(cfg: ModelConfig, d_ff: int) -> int:
    return 3 * cfg.d_model * d_ff  # gate, up, down


def _ffn_moe_params(cfg: ModelConfig, active_only: bool) -> int:
    m = cfg.moe
    n_routed = m.top_k if active_only else m.n_experts
    n = n_routed * 3 * cfg.d_model * m.d_expert
    n += m.n_shared * 3 * cfg.d_model * m.d_expert
    n += cfg.d_model * m.n_experts   # router
    return n


def _mamba_params(cfg: ModelConfig) -> int:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.headdim
    conv_dim = d_in + 2 * s.ngroups * s.d_state
    n = cfg.d_model * (2 * d_in + 2 * s.ngroups * s.d_state + nheads)  # in_proj
    n += conv_dim * s.conv_width                                        # conv
    n += 3 * nheads + d_in                                              # A_log, D, dt_bias, out norm
    n += d_in * cfg.d_model                                             # out_proj
    return n


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    prefix, period, n_periods = layer_pattern(cfg)
    layers = list(prefix) + [spec for _ in range(n_periods) for spec in period]
    total = cfg.vocab_size * cfg.d_model
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * cfg.d_model
    for spec in layers:
        if spec.mixer in ("attn", "attn_local"):
            total += _attn_params(cfg) + 2 * cfg.d_model
        else:
            total += _mamba_params(cfg) + cfg.d_model
        if spec.ffn == "dense":
            total += _ffn_dense_params(cfg, cfg.d_ff) + cfg.d_model
        elif spec.ffn == "moe":
            total += _ffn_moe_params(cfg, active_only) + cfg.d_model
    total += cfg.d_model  # final norm
    if cfg.is_encoder_decoder:
        # encoder stack: self-attn + dense ffn; decoder adds cross-attn
        enc = cfg.n_encoder_layers * (_attn_params(cfg) + _ffn_dense_params(cfg, cfg.d_ff)
                                      + 3 * cfg.d_model)
        cross = cfg.n_layers * (_attn_params(cfg) + cfg.d_model)
        total += enc + cross
    return total


# ---------------------------------------------------------------------------
# input shapes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,   32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",  524_288,    1, "decode"),
}


# ---------------------------------------------------------------------------
# reduced variant for smoke tests
# ---------------------------------------------------------------------------

def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """2 layers, d_model<=512, <=4 experts — same family, CPU-runnable."""
    d_model = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    kw = dict(
        n_layers=2, d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
        head_dim=64 if cfg.head_dim else 0,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 1024),
        window=min(cfg.window, 64) if cfg.window else 0,
        long_context_window=64,
        encoder_len=16,
        n_encoder_layers=2 if cfg.is_encoder_decoder else 0,
    )
    if cfg.moe:
        kw["moe"] = replace(cfg.moe, n_experts=4, top_k=2, d_expert=128,
                            n_shared=min(cfg.moe.n_shared, 1),
                            n_dense_prefix=min(cfg.moe.n_dense_prefix, 0))
        kw["n_layers"] = 2 * max(1, cfg.moe.moe_every)
    if cfg.mla:
        kw["mla"] = MLAConfig(kv_lora_rank=64, q_lora_rank=32 if cfg.mla.q_lora_rank else 0,
                              qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32)
    if cfg.ssm:
        kw["ssm"] = replace(cfg.ssm, d_state=16, headdim=32, chunk=16)
    if cfg.attn_every:
        kw["attn_every"] = 4
        kw["n_layers"] = 8          # 2 periods of 4
        if cfg.moe:
            kw["moe"] = replace(kw["moe"], moe_every=2)
    if cfg.local_global_period:
        kw["n_layers"] = 2 * cfg.local_global_period
    return replace(cfg, name=cfg.name + "-smoke", **kw)
