"""Core layers: RMSNorm and LayerNorm, RoPE, softcap, the gated MLP and
Whisper's ungated one, GQA attention and DeepSeek-V2's multi-head
latent attention (MLA), each attention with its full-sequence, dense
(ring-buffer) and paged decode modes.

A port of ``repro.models.layers`` (dense GQA, sliding window, softcaps,
QK-norm, MLA, and Whisper's LayerNorm, biased MLP and cross-attention
projections; the cross-attention itself is assembled in
``models.transformer``, as in the JAX package).  Parameters of
one block arrive as a flat dict keyed by the leaf name under the block
("wq", "scale", ...).  Numerics follow the JAX package: fp32 norms,
RoPE and softmax, matmuls in the compute dtype; each function says
where the port's PyTorch idiom differs.  ``cfg.sdpa_bf16`` runs the
attention score products bf16-in, f32-out (``bf16_dot``), as the JAX
package's ``_sdpa(bf16_mm=True)`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.models.param import ParamDef

NEG_INF = -2.0e38  # large-negative for masking (fp32-safe)


# ---------------------------------------------------------------------------
# bf16-in, f32-out products
# ---------------------------------------------------------------------------

def _split3(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` (..., M, N) as three bf16 terms hi + mid + lo stacked on
    the rows, (..., 3M, N).  Each term holds 8 of fp32's 24 significand
    bits and each difference is exact, so the three sum to ``x`` exactly
    (short of the subnormal range), and their products with a bf16
    operand are exact in fp32."""
    *lead, M, N = x.shape
    out = torch.empty((*lead, 3, M, N), dtype=torch.bfloat16, device=x.device)
    hi, mid, lo = out.unbind(-3)
    hi.copy_(x)
    r = x - hi
    mid.copy_(r)
    lo.copy_(r.sub_(mid))
    return out.view(*lead, 3 * M, N)


# products one GEMM sums into an output: the tensor cores' fp32
# accumulation truncates, and over the vocabulary (256000 products, the
# logits' backward) that drifted 9.7e-5 of the max beyond a bf16 step
# from an fp32 GEMM on an H100; longer contractions run in chunks of
# K_CHUNK whose fp32 results are added in order
K_CHUNK = 4096


def _mm_f32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """bf16 ``x @ y`` (2-D, or batched 3-D) accumulated and returned in
    fp32.  On a CUDA tensor the tensor cores (``torch.mm``/``torch.bmm``
    with ``out_dtype``); on a CPU tensor the operands lifted to fp32,
    where the products of bf16 values are exact and only the order of
    the sums differs.  A contraction longer than ``K_CHUNK`` is summed a
    chunk at a time."""
    if x.is_cuda:
        mm = torch.mm if x.dim() == 2 else torch.bmm
        prod = lambda u, v: mm(u, v, out_dtype=torch.float32)   # noqa: E731
    else:
        prod = lambda u, v: u.float() @ v.float()               # noqa: E731
    n = x.shape[-1]
    out = prod(x[..., :K_CHUNK], y[..., :K_CHUNK, :])
    for k0 in range(K_CHUNK, n, K_CHUNK):
        out.add_(prod(x[..., k0:k0 + K_CHUNK], y[..., k0:k0 + K_CHUNK, :]))
    return out


class _Bf16Dot(torch.autograd.Function):
    """bf16 ``a @ b`` accumulated and returned in fp32, and the JAX
    package's transpose of ``dot_general(preferred_element_type=f32)``:
    each operand's cotangent is the fp32 output cotangent times the
    other (bf16) operand, summed in fp32, then rounded to the operand's
    dtype.  The cotangent itself is not rounded: XLA multiplies the fp32
    cotangent by the bf16 operand in fp32.  Here the cotangent enters
    bf16 products as its three exact bf16 terms (``_split3``), stacked
    on the rows: one product, whose row thirds are added, for ``a``'s
    cotangent, and one product that sums over all three for ``b``'s."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        return _bf16_dot_grads(*ctx.saved_tensors, g, *ctx.needs_input_grad)


def _bf16_dot_grads(a, b, g, need_a: bool = True, need_b: bool = True):
    """``_Bf16Dot``'s cotangents of bf16 ``a`` and ``b`` for the fp32
    output cotangent ``g`` (None where not needed)."""
    g3 = _split3(g)                                           # (..., 3M, N)
    da = db = None
    if need_a:
        da = _mm_f32(g3, b.mT).unflatten(-2, (3, g.shape[-2])).sum(-3)
        da = da.to(a.dtype)
    if need_b:
        db = _mm_f32(torch.cat([a.mT] * 3, -1), g3).to(b.dtype)
    return da, db


def bf16_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of the operands rounded to bf16, accumulated and
    returned in fp32: the JAX package's ``einsum(a.astype(bf16),
    b.astype(bf16), preferred_element_type=f32)``.  a (M, K) and b
    (K, N), or a batch of each, (n, M, K) and (n, K, N).  The rounding
    of an fp32 operand is an autograd cast, so its cotangent comes back
    in fp32, as ``astype``'s does.  The card and the CPU run the same
    products (``_mm_f32``), each on its own device's GEMM."""
    return _Bf16Dot.apply(a.bfloat16(), b.bfloat16())


def bf16_dot_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``bf16_dot``'s plain form: the operands rounded to bf16 and lifted
    back to fp32, multiplied in fp32.  Autograd through it is the same
    rule: the fp32 cotangent times the other operand in fp32, rounded to
    bf16 by the lift's backward."""
    return a.bfloat16().float() @ b.bfloat16().float()


# ---------------------------------------------------------------------------
# norms, RoPE, softcap
# ---------------------------------------------------------------------------

def rmsnorm_defs(dim: int):
    return {"scale": ParamDef((dim,), ("norm",), "ones")}


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def layernorm_defs(dim: int):
    return {"scale": ParamDef((dim,), ("norm",), "ones"),
            "bias": ParamDef((dim,), ("norm",), "zeros")}


def layernorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
              eps: float = 1e-5):
    """The JAX package's formula in fp32, population variance, eps fixed
    at 1e-5 (``cfg.norm_eps`` is not read there either).  Not
    ``F.layer_norm``, which may sum in another order."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


def norm_defs(cfg: ModelConfig):
    """LayerNorm for Whisper (a GELU encoder-decoder), RMSNorm otherwise."""
    return (layernorm_defs(cfg.d_model)
            if cfg.act == "gelu" and cfg.is_encoder_decoder
            else rmsnorm_defs(cfg.d_model))


def apply_norm(cfg: ModelConfig, p, x):
    """``p`` is the norm's subtree, {"scale"} or {"scale", "bias"}: a
    bias makes it a LayerNorm."""
    if "bias" in p:
        return layernorm(p["scale"], p["bias"], x)
    return rmsnorm(p["scale"], x, cfg.norm_eps)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, llama split-half convention, in fp32.

    x: (B, S, n_heads_or_1, hd) ; pos: (B, S) absolute positions."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = pos[..., None, None].float() * freqs             # (B,S,1,half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# MLP (gated SwiGLU / GeGLU and Whisper's ungated one)
# ---------------------------------------------------------------------------

def mlp_defs(cfg: ModelConfig, d_ff: int, gated: bool = True):
    d = cfg.d_model
    if gated:
        return {"wg": ParamDef((d, d_ff), ("embed", "ffn")),
                "wu": ParamDef((d, d_ff), ("embed", "ffn")),
                "wd": ParamDef((d_ff, d), ("ffn", "embed"))}
    return {"w1": ParamDef((d, d_ff), ("embed", "ffn")),
            "b1": ParamDef((d_ff,), ("ffn",), "zeros"),
            "w2": ParamDef((d_ff, d), ("ffn", "embed")),
            "b2": ParamDef((d,), ("norm",), "zeros")}


def _act(cfg: ModelConfig, x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh") if cfg.act == "gelu" else F.silu(x)


def mlp(p, x, cfg: ModelConfig):
    cdt = getattr(torch, cfg.compute_dtype)
    xc = x.to(cdt)
    if "wg" in p:
        h = _act(cfg, xc @ p["wg"].to(cdt)) * (xc @ p["wu"].to(cdt))
        return h @ p["wd"].to(cdt)
    h = _act(cfg, xc @ p["w1"].to(cdt) + p["b1"].to(cdt))
    return h @ p["w2"].to(cdt) + p["b2"].to(cdt)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def attention_defs(cfg: ModelConfig, cross: bool = False):
    """A cross-attention's projections are GQA's, never MLA's, and carry
    no QK-norm."""
    d, H, K = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    if cfg.mla is not None and not cross:
        m = cfg.mla
        qk_hd = m.qk_nope_dim + m.qk_rope_dim
        defs = {
            "wkv_a": ParamDef((d, m.kv_lora_rank + m.qk_rope_dim),
                              ("embed", "kv_lora_in")),
            "kv_norm": ParamDef((m.kv_lora_rank,), ("norm",), "ones"),
            "wk_b": ParamDef((m.kv_lora_rank, H, m.qk_nope_dim),
                             ("kv_lora", "heads", "head_dim")),
            "wv_b": ParamDef((m.kv_lora_rank, H, m.v_head_dim),
                             ("kv_lora", "heads", "head_dim")),
            "wo": ParamDef((H, m.v_head_dim, d), ("heads", "head_dim", "embed")),
        }
        if m.q_lora_rank:
            defs["wq_a"] = ParamDef((d, m.q_lora_rank), ("embed", "q_lora"))
            defs["q_norm"] = ParamDef((m.q_lora_rank,), ("norm",), "ones")
            defs["wq_b"] = ParamDef((m.q_lora_rank, H, qk_hd),
                                    ("q_lora", "heads", "head_dim"))
        else:
            defs["wq"] = ParamDef((d, H, qk_hd), ("embed", "heads", "head_dim"))
        return defs
    defs = {
        "wq": ParamDef((d, H, hd), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, K, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, K, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((H, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm and not cross:
        defs["qn"] = ParamDef((hd,), ("norm",), "ones")
        defs["kn"] = ParamDef((hd,), ("norm",), "ones")
    return defs


def _qk_rms(x, scale, eps):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _proj_in(x, w):
    """einsum("bsd,dkh->bskh") as one matmul over the flattened heads."""
    d, n, hd = w.shape
    return (x @ w.reshape(d, n * hd)).unflatten(-1, (n, hd))


def _proj_out(o, w):
    """einsum("bshd,hdo->bso") as one matmul over the flattened heads."""
    n, hd, d = w.shape
    return o.flatten(-2) @ w.reshape(n * hd, d)


def ring_cache(entries, S: int, window: int):
    """Compress full-seq cache entries {name: (B,S,...)} plus their
    implicit positions arange(S) into a ring buffer of size ``window``
    (slot = pos % window), so a windowed layer's decode state is O(W),
    not O(S).  Without a window, or with S <= window, the entries are
    kept whole and unrotated."""
    first = next(iter(entries.values()))
    B, dev = first.shape[0], first.device
    if window <= 0 or S <= window:
        sp = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
        return {**entries, "slot_pos": sp}
    pos = torch.arange(S - window, S, dtype=torch.int32, device=dev)  # kept
    slots = (pos % window).long()                  # a permutation of 0..W-1
    inv = torch.zeros(window, dtype=torch.long, device=dev).index_put_(
        (slots,), torch.arange(window, device=dev))
    out = {k: v[:, -window:][:, inv] for k, v in entries.items()}
    out["slot_pos"] = pos[inv].expand(B, window)
    return out


def _chunk_mask(q0: int, Qc: int, T: int, causal: bool, window: int, device):
    """(Qc,T) additive mask for the q-rows [q0, q0+Qc)."""
    i = q0 + torch.arange(Qc, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    ok = torch.ones((Qc, T), dtype=torch.bool, device=device)
    if causal:
        ok &= j <= i
    if window > 0:
        ok &= j > i - window
    return torch.where(ok, 0.0, NEG_INF).float()


def _sdpa(q, k, v, mask, cap, scale, bf16_mm: bool = False):
    """q: (B,S,H,hd)  k,v: (B,T,K,hd), K | H.  mask: broadcast (B,H,S,T).

    Scores and softmax in fp32; the probabilities are cast to v's dtype
    for the PV product, as in the JAX package.  ``bf16_mm``: the score
    product takes the scaled q and k rounded to bf16 (``bf16_dot``), as
    the JAX package's does.  GQA groups the G = H/K query heads of a kv
    head in one batched matmul instead of repeating K/V (same head
    mapping: head h reads kv head h // G)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qf = (q.float() * scale).reshape(B, S, K, G, hd).permute(0, 2, 3, 1, 4)
    if bf16_mm:
        s = bf16_dot(qf.reshape(B * K, G * S, hd),
                     k.permute(0, 2, 3, 1).reshape(B * K, hd, T))
    else:
        s = qf @ k.float().permute(0, 2, 3, 1)[:, :, None]   # (B,K,1,hd,T)
    s = s.reshape(B, H, S, T)
    s = softcap(s, cap) + mask
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = p.reshape(B, K, G, S, T) @ v.permute(0, 2, 1, 3)[:, :, None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, v.shape[-1])


Q_CHUNK = 1024


def _sdpa_seq(q, k, v, causal: bool, window: int, cap, scale,
              bf16_mm: bool = False):
    """Full-sequence attention, chunked over the query dim so scores
    exist only per (Q_CHUNK, T) block.  Plain torch matmuls: the JAX
    package has no Pallas kernel here either."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    masked = causal or window

    def mask(q0, Qc):
        return (_chunk_mask(q0, Qc, T, causal, window, q.device) if masked
                else torch.zeros((), dtype=torch.float32, device=q.device))

    if S <= Q_CHUNK or S % Q_CHUNK != 0:
        return _sdpa(q, k, v, mask(0, S), cap, scale, bf16_mm)
    return torch.cat([_sdpa(q[:, c:c + Q_CHUNK], k, v, mask(c, Q_CHUNK),
                            cap, scale, bf16_mm)
                      for c in range(0, S, Q_CHUNK)], dim=1)


def _paged_write(pool, new, bt, pos):
    """Write this step's entry into the block pool through the table:
    pool (nb, bs, *tail) <- new (B, 1, *tail) at absolute position
    pos (B,).  In place (``index_put_``), where the JAX package returns
    a functional copy (``pool.at[bid, off].set``).  Active slots always
    target a private (refcount-1) block; inactive slots target the
    reserved scratch block 0."""
    bs = pool.shape[1]
    B = bt.shape[0]
    rows = torch.arange(B, device=bt.device)
    bid = bt[rows, (pos // bs).long()].long()
    off = (pos % bs).long()
    pool.index_put_((bid, off), new[:, 0].to(pool.dtype))


def _paged_gather(pool, bt):
    """Dense (B, nbmax*bs, *tail) view of a slot's entries gathered
    through its block table.  Positions t <= pos hold real entries in
    position order; everything else is garbage that the caller masks."""
    B, nbmax = bt.shape
    bs = pool.shape[1]
    return pool[bt.long()].reshape((B, nbmax * bs) + tuple(pool.shape[2:]))


def _paged_valid(pos, T: int, window: int):
    """(B, T) validity mask for gathered entries: written and causal
    (t <= pos), inside the sliding window when one applies."""
    t_ids = torch.arange(T, dtype=torch.int32, device=pos.device)[None, :]
    valid = t_ids <= pos[:, None]
    if window > 0:
        valid &= t_ids > pos[:, None] - window
    return valid


def gqa_attention(p, x, cfg: ModelConfig, *, local: bool, pos, cache=None,
                  causal: bool = True, paged_kernel: bool = True,
                  build_cache: bool = True):
    """Modes:
      * full-seq (train/prefill): cache=None, pos (B,S) absolute
        positions; returns the cache {"k", "v", "slot_pos"} (a ring of
        the last W positions on a windowed layer when S > W, see
        ``ring_cache``), or None with ``build_cache=False`` (training
        keeps none).
      * dense decode: cache={"k","v","slot_pos"} (B,Sc,...), x (B,1,d),
        pos (B,) current index; entry and position written at ring
        slot pos % Sc.
      * paged decode: cache={"kp","vp","bt"}, x (B,1,d), pos (B,).
    In both decode modes the cache's tensors are written in place
    (``index_put_``) and the same dict is returned, where the JAX
    package returns new arrays.  ``cfg.sdpa_bf16`` reaches the full
    sequence, the dense decode and the paged plain gather, as in the JAX
    package; the paged kernel is called as without it.  Returns (out,
    cache)."""
    cdt = getattr(torch, cfg.compute_dtype)
    hd = cfg.resolved_head_dim
    xc = x.to(cdt)
    window = cfg.window if local else 0

    q = _proj_in(xc, p["wq"].to(cdt))
    k = _proj_in(xc, p["wk"].to(cdt))
    v = _proj_in(xc, p["wv"].to(cdt))
    if cfg.qk_norm:
        q = _qk_rms(q, p["qn"], cfg.norm_eps)
        k = _qk_rms(k, p["kn"], cfg.norm_eps)
    pos2 = pos if pos.dim() == 2 else pos[:, None]
    q = rope(q, pos2, cfg.rope_theta)
    k = rope(k, pos2, cfg.rope_theta)
    scale = hd ** -0.5

    if cache is None:                                   # full sequence
        o = _sdpa_seq(q, k, v, causal, window, cfg.attn_softcap, scale,
                      cfg.sdpa_bf16)
        new_cache = (ring_cache({"k": k, "v": v}, x.shape[1], window)
                     if causal and build_cache else None)
        return _proj_out(o, p["wo"].to(cdt)), new_cache

    if "kp" not in cache:                               # dense ring decode
        ck, cv, sp = cache["k"], cache["v"], cache["slot_pos"]
        rows = torch.arange(x.shape[0], device=pos.device)
        slot = (pos % ck.shape[1]).long()
        ck.index_put_((rows, slot), k[:, 0].to(ck.dtype))
        cv.index_put_((rows, slot), v[:, 0].to(cv.dtype))
        sp.index_put_((rows, slot), pos.to(sp.dtype))
        valid = (sp >= 0) & (sp <= pos[:, None])
        if window > 0:
            valid &= sp > pos[:, None] - window
        mask = torch.where(valid, 0.0, NEG_INF).float()[:, None, None, :]
        o = _sdpa(q, ck.to(cdt), cv.to(cdt), mask, cfg.attn_softcap, scale,
                  cfg.sdpa_bf16)
        return _proj_out(o, p["wo"].to(cdt)), cache
    # ---- paged decode (x is (B,1,d)) ----
    kp, vp, bt = cache["kp"], cache["vp"], cache["bt"]
    _paged_write(kp, k, bt, pos)
    _paged_write(vp, v, bt, pos)
    if paged_kernel:
        o = paged_attention(q[:, 0].contiguous(), kp, vp, bt, pos,
                            window=window, softcap=cfg.attn_softcap)[:, None]
    else:
        kd = _paged_gather(kp, bt)
        vd = _paged_gather(vp, bt)
        valid = _paged_valid(pos, kd.shape[1], window)
        mask = torch.where(valid, 0.0, NEG_INF).float()[:, None, None, :]
        o = _sdpa(q, kd.to(cdt), vd.to(cdt), mask, cfg.attn_softcap, scale,
                  cfg.sdpa_bf16)
    return _proj_out(o.to(cdt), p["wo"].to(cdt)), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

def _mla_q(p, xc, cfg: ModelConfig, cdt):
    m = cfg.mla
    if m.q_lora_rank:
        ql = rmsnorm(p["q_norm"], xc @ p["wq_a"].to(cdt), cfg.norm_eps)
        q = _proj_in(ql.to(cdt), p["wq_b"].to(cdt))
    else:
        q = _proj_in(xc, p["wq"].to(cdt))
    return q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]


def _mla_absorbed(p, q_nope, q_rope, ckv, kr, valid, cfg: ModelConfig, cdt,
                  scale):
    """Absorbed decode attention in the kv_lora latent space, the same
    ops for the dense ring and the paged gather.  q_nope (B,1,H,nope),
    q_rope (B,1,H,rr); ckv (B,T,r) and kr (B,T,rr) the cached latents;
    valid (B,T).  Scores and softmax in fp32, the probabilities cast to
    the compute dtype for the context product, as in the JAX package."""
    q_lat = torch.einsum("bskh,rkh->bskr", q_nope, p["wk_b"].to(cdt))
    s = torch.einsum("bskr,btr->bkst", q_lat.float(), ckv.float())
    s = s + torch.einsum("bskh,bth->bkst", q_rope.float(), kr.float())
    s = s * scale
    s = softcap(s, cfg.attn_softcap) + \
        torch.where(valid, 0.0, NEG_INF).float()[:, None, None, :]
    prob = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bkst,btr->bskr", prob.to(cdt), ckv.to(cdt))
    o = torch.einsum("bskr,rkh->bskh", ctx, p["wv_b"].to(cdt))  # (B,1,H,vhd)
    return _proj_out(o, p["wo"].to(cdt))


def mla_attention(p, x, cfg: ModelConfig, *, local: bool, pos, cache=None,
                  build_cache: bool = True):
    """MLA.  Modes, as ``gqa_attention``'s:
      * full-seq: K/V decompressed from the latent (standard MHA form,
        the shared RoPE key broadcast over the heads); the cache is
        {"ckv", "krope", "slot_pos"} (``ring_cache``), only the latents;
      * dense decode: cache={"ckv","krope","slot_pos"}, written at ring
        slot pos % Sc in place, then absorbed attention;
      * paged decode: cache={"ckvp","kropep","bt"}, the latent pools
        (n_blocks, bs, r) / (n_blocks, bs, rr), written and gathered
        through the block table in plain PyTorch, as the JAX package
        does (no paged-attention kernel serves MLA).
    ``cfg.sdpa_bf16`` reaches the full sequence only: the absorbed decode
    keeps its fp32 score products, as in the JAX package.
    Returns (out, cache)."""
    cdt = getattr(torch, cfg.compute_dtype)
    m = cfg.mla
    H = cfg.n_heads
    B = x.shape[0]
    xc = x.to(cdt)
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    window = cfg.window if local else 0

    q_nope, q_rope = _mla_q(p, xc, cfg, cdt)
    kv_a = xc @ p["wkv_a"].to(cdt)                         # (B,S,lora+rope)
    ckv = rmsnorm(p["kv_norm"], kv_a[..., :m.kv_lora_rank],
                  cfg.norm_eps).to(cdt)
    k_rope = kv_a[..., m.kv_lora_rank:]                    # shared by the heads

    pos2 = pos if pos.dim() == 2 else pos[:, None]
    q_rope = rope(q_rope, pos2, cfg.rope_theta)
    k_rope = rope(k_rope[..., None, :], pos2, cfg.rope_theta)[..., 0, :]

    if cache is None:                                   # full sequence
        S = x.shape[1]
        k_nope = _proj_in(ckv, p["wk_b"].to(cdt))
        v = _proj_in(ckv, p["wv_b"].to(cdt))
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            B, S, H, m.qk_rope_dim)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)            # (B,S,H,qk)
        o = _sdpa_seq(q, k, v, True, window, cfg.attn_softcap, scale,
                      cfg.sdpa_bf16)
        new_cache = (ring_cache({"ckv": ckv, "krope": k_rope}, S, window)
                     if build_cache else None)
        return _proj_out(o, p["wo"].to(cdt)), new_cache

    if "ckvp" in cache:                                 # paged latent pools
        ckvp, kropep, bt = cache["ckvp"], cache["kropep"], cache["bt"]
        _paged_write(ckvp, ckv, bt, pos)
        _paged_write(kropep, k_rope, bt, pos)
        ckv_d = _paged_gather(ckvp, bt)                   # (B, T, r)
        kr_d = _paged_gather(kropep, bt)                  # (B, T, rr)
        valid = _paged_valid(pos, ckv_d.shape[1], window)
        return _mla_absorbed(p, q_nope, q_rope, ckv_d, kr_d, valid, cfg, cdt,
                             scale), cache
    # dense ring decode
    cc, ck, sp = cache["ckv"], cache["krope"], cache["slot_pos"]
    rows = torch.arange(B, device=pos.device)
    slot = (pos % cc.shape[1]).long()
    cc.index_put_((rows, slot), ckv[:, 0].to(cc.dtype))
    ck.index_put_((rows, slot), k_rope[:, 0].to(ck.dtype))
    sp.index_put_((rows, slot), pos.to(sp.dtype))
    valid = (sp >= 0) & (sp <= pos[:, None])
    if window > 0:
        valid &= sp > pos[:, None] - window
    return _mla_absorbed(p, q_nope, q_rope, cc, ck, valid, cfg, cdt,
                         scale), cache
