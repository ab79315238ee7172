"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) on one device.

A port of ``repro.models.mamba``.  Training and prefill use the chunked
SSD algorithm: an intra-chunk "attention-like" quadratic term plus a
linear recurrence over chunk states (the JAX package's ``lax.scan``
over chunks is a Python loop here).  Decode is the O(1) recurrent
update of the (B, H, P, N) SSM state.  The projections are separate
tensors (wz/wx/wB/wC/wdt), as in the JAX tree.

Dtypes follow the reference op by op: the projections and the conv in
the compute dtype, ``dt`` through softplus in fp32 with ``dt_bias``,
``A = -exp(A_log)`` in fp32, the SSM state in fp32.

Decode writes the conv tail and the SSM state of the cache it is given
in place (the views of ``forward``'s stacked leaves), where the JAX
package returns new arrays.  One departure from the reference: a
prefill that builds a cache refuses a prompt shorter than
``conv_width - 1`` tokens (``ValueError``).  The reference builds no
cache for it, and its next decode step silently restarts the
recurrence from that one token.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.param import ParamDef


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.headdim
    return s, d_in, H, s.headdim, s.d_state, s.ngroups


def mamba_defs(cfg: ModelConfig):
    s, d_in, H, P_, N, G = _dims(cfg)
    conv_dim = d_in + 2 * G * N
    d = cfg.d_model
    return {
        "wz": ParamDef((d, d_in), ("embed", "inner")),
        "wx": ParamDef((d, d_in), ("embed", "inner")),
        "wB": ParamDef((d, G * N), ("embed", None)),
        "wC": ParamDef((d, G * N), ("embed", None)),
        "wdt": ParamDef((d, H), ("embed", "heads")),
        "conv_w": ParamDef((s.conv_width, conv_dim), (None, "inner")),
        "conv_b": ParamDef((conv_dim,), ("inner",), "zeros"),
        "A_log": ParamDef((H,), ("heads",), "arange_log"),
        "D": ParamDef((H,), ("heads",), "ones"),
        "dt_bias": ParamDef((H,), ("heads",), "zeros"),
        "norm": ParamDef((d_in,), ("inner",), "ones"),
        "out_proj": ParamDef((d_in, d), ("inner", "embed")),
    }


def state_shapes(cfg: ModelConfig, B: int):
    """Decode state of B sequences: the conv tail (B, W-1, conv_dim) in
    the compute dtype and the SSM state (B, H, P, N) in fp32."""
    s, d_in, H, P_, N, G = _dims(cfg)
    return {"conv": ((B, s.conv_width - 1, d_in + 2 * G * N),
                     getattr(torch, cfg.compute_dtype)),
            "ssm": ((B, H, P_, N), torch.float32)}


def _silu(x):
    """``jax.nn.silu`` as written, x * sigmoid(x): in bf16 the sigmoid is
    rounded before the product (``F.silu`` rounds once)."""
    return x * torch.sigmoid(x)


def _gated_rmsnorm(scale, y, z, eps):
    """Mamba2 output norm: RMSNorm(y * silu(z)), silu(z) rounded to y's
    dtype before the product."""
    yf = (y * _silu(z.float()).to(y.dtype)).float()
    var = yf.square().mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def _conv_full(xBC, w, b):
    """Causal depthwise conv over (B,S,C) with kernel (W,C)."""
    W, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(W))
    return _silu(out + b)


def _segsum(x):
    """Stable segment-sum: out[..., i, j] = sum_{j < k <= i} x[..., k],
    -inf above the diagonal (masked before any ``exp``, so no inf - inf
    reaches a value or a gradient)."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, out, float("-inf"))


# ---------------------------------------------------------------------------
# chunked SSD forward (train / prefill)
# ---------------------------------------------------------------------------

def ssd_chunked(x, dt, A, B_, C_, chunk: int, h0=None):
    """SSD over a full sequence.

    x:  (B, S, H, P)   dt: (B, S, H)   A: (H,) (negative)
    B_: (B, S, G, N)   C_: (B, S, G, N)
    Returns y (B, S, H, P) fp32 and the final state (B, H, P, N) fp32.
    """
    Bb, S, H, P_ = x.shape
    G, N = B_.shape[2], B_.shape[3]
    if S % chunk:
        raise ValueError(f"ssd_chunked: S {S} is not a multiple of chunk {chunk}")
    nc = S // chunk
    rep = H // G

    # reshape into chunks; broadcast groups to heads
    xc = x.reshape(Bb, nc, chunk, H, P_)
    dtc = dt.reshape(Bb, nc, chunk, H)
    Bc = B_.reshape(Bb, nc, chunk, G, N).repeat_interleave(rep, dim=3)
    Cc = C_.reshape(Bb, nc, chunk, G, N).repeat_interleave(rep, dim=3)

    dA = dtc * A                                                # (B,nc,Q,H), negative
    dA_cs = torch.cumsum(dA, dim=2)                             # within-chunk cumsum

    # 1) intra-chunk (quadratic in chunk length)
    L = torch.exp(_segsum(dA.movedim(-1, -2)))                  # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Cc, Bc)         # (B,nc,H,Q,Q)
    xdt = xc * dtc[..., None]                                   # dt-weighted input
    y_diag = torch.einsum("bchqk,bchqk,bckhp->bcqhp",
                          scores.float(), L, xdt.float())

    # 2) chunk states: state_c = sum_q decay_out[q] * B[q] x~[q]
    decay_out = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)          # (B,nc,Q,H)
    states = torch.einsum("bcqhn,bcqh,bcqhp->bchpn",
                          Bc.float(), decay_out, xdt.float())

    # 3) inter-chunk recurrence over chunk states; h_prev[c] is the
    # state BEFORE chunk c, the last state is returned on its own
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])                 # (B,nc,H)
    h = (torch.zeros((Bb, H, P_, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    prev = []
    for c in range(nc):
        prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(prev, dim=1)                           # (B,nc,H,P,N)

    # 4) inter-chunk output: y_off[q] = C[q] . (decay_in[q] * h_prev)
    decay_in = torch.exp(dA_cs)                                 # (B,nc,Q,H)
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp",
                         Cc.float(), h_prev, decay_in)

    y = (y_diag + y_off).reshape(Bb, S, H, P_)
    return y, h


# ---------------------------------------------------------------------------
# block apply
# ---------------------------------------------------------------------------

def mamba_block(p: Dict[str, torch.Tensor], x, cfg: ModelConfig, *,
                cache: Optional[dict] = None, build_cache: bool = True):
    """x: (B,S,d).  Modes:
      * full sequence (cache None): returns (out, {"conv": (B,W-1,conv_dim)
        raw pre-conv tail in the compute dtype, "ssm": (B,H,P,N) fp32}),
        or (out, None) with ``build_cache=False`` (training);
      * decode (S == 1): cache {"conv", "ssm"}, written in place and
        returned."""
    s, d_in, H, P_, N, G = _dims(cfg)
    cdt = getattr(torch, cfg.compute_dtype)
    Bb, S, _ = x.shape
    W = s.conv_width
    if cache is None and build_cache and S < W - 1:
        raise ValueError(f"mamba prefill of {S} tokens builds no decode state: "
                         f"a prompt needs at least conv_width - 1 = {W - 1} "
                         f"tokens")
    xc = x.to(cdt)

    z = xc @ p["wz"].to(cdt)                                    # (B,S,d_in)
    xin = xc @ p["wx"].to(cdt)
    Bv = xc @ p["wB"].to(cdt)
    Cv = xc @ p["wC"].to(cdt)
    dt = xc @ p["wdt"].to(cdt)                                  # (B,S,H)
    A = -torch.exp(p["A_log"].float())                          # (H,)
    dt_bias = p["dt_bias"].float()

    raw = torch.cat([xin, Bv, Cv], dim=-1)                      # (B,S,conv_dim)

    if cache is None:
        xBC = _conv_full(raw, p["conv_w"].to(cdt), p["conv_b"].to(cdt))
        xin2 = xBC[..., :d_in].reshape(Bb, S, H, P_)
        Bm = xBC[..., d_in:d_in + G * N].reshape(Bb, S, G, N)
        Cm = xBC[..., d_in + G * N:].reshape(Bb, S, G, N)
        dtv = F.softplus(dt.float() + dt_bias)
        # pad S to a chunk multiple with zero post-softplus dt: exp(0*A)=1
        # and x*dt=0, so the padded tail is an identity recurrence
        chunk = min(s.chunk, S)
        pad = -S % chunk
        if pad:
            def pz(a):
                return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
            y, h_last = ssd_chunked(pz(xin2), pz(dtv), A, pz(Bm), pz(Cm), chunk)
            y = y[:, :S]
        else:
            y, h_last = ssd_chunked(xin2, dtv, A, Bm, Cm, chunk)
        y = y + p["D"].float()[:, None] * xin2.float()
        y = y.reshape(Bb, S, d_in).to(cdt)
        y = _gated_rmsnorm(p["norm"], y, z, cfg.norm_eps)
        out = y.to(cdt) @ p["out_proj"].to(cdt)
        if not build_cache:
            return out, None
        # the raw (pre-conv) tail continues the conv at decode
        return out, {"conv": raw[:, S - (W - 1):, :].to(cdt),
                     "ssm": h_last.float()}

    # ---- decode: O(1) recurrent update, S == 1 ----
    conv, ssm = cache["conv"], cache["ssm"]
    conv_buf = torch.cat([conv, raw[:, :1, :].to(conv.dtype)], dim=1)  # (B,W,C), a copy
    w = p["conv_w"].to(cdt)
    conv_out = torch.einsum("bwc,wc->bc", conv_buf, w) + p["conv_b"].to(cdt)
    conv_out = _silu(conv_out)

    xin2 = conv_out[:, :d_in].reshape(Bb, H, P_)
    rep = H // G
    Bm = conv_out[:, d_in:d_in + G * N].reshape(Bb, G, N).repeat_interleave(rep, 1)
    Cm = conv_out[:, d_in + G * N:].reshape(Bb, G, N).repeat_interleave(rep, 1)
    dtv = F.softplus(dt[:, 0].float() + dt_bias)
    dAe = torch.exp(dtv * A)                                    # (B,H)
    xdt = xin2.float() * dtv[..., None]
    h_new = ssm * dAe[..., None, None] + torch.einsum("bhp,bhn->bhpn", xdt,
                                                      Bm.float())
    y = torch.einsum("bhpn,bhn->bhp", h_new, Cm.float())
    y = y + p["D"].float()[:, None] * xin2.float()
    y = y.reshape(Bb, 1, d_in).to(cdt)
    y = _gated_rmsnorm(p["norm"], y, z, cfg.norm_eps)
    out = y.to(cdt) @ p["out_proj"].to(cdt)
    conv.copy_(conv_buf[:, 1:])            # conv_buf is a copy: no overlap
    ssm.copy_(h_new)
    return out, cache
