"""Mixture-of-Experts FFN with capacity-based dispatch, on one device.

A port of ``repro.models.moe`` in its mesh-free form: the JAX package's
``_moe_body`` with one expert shard (``mode="a2a"``, ``n_ep=1``), which
is what its ``moe_apply`` runs when the runtime has no mesh.  Tokens are
routed (``route``), each (token, expert) assignment takes the next free
row of its expert's capacity buffer in token-major, rank-minor order
(``_positions``), assignments past the capacity are dropped, the
experts run as batched matmuls over their buffers, and each token sums
its kept rows weighted by its router weights.  The sharded branch
(experts over an ``ep`` mesh axis, ``all_to_all``) is not ported.

Where the PyTorch idiom differs from the JAX one:

  * top-k is a stable descending sort, so tied scores keep the lowest
    expert id first, as ``jax.lax.top_k`` does (``torch.topk`` documents
    no tie order); which assignments are dropped depends on that order;
  * the JAX scatter into the buffers drops out-of-range capacity
    positions and its gather clamps them; here both use the position
    clamped to the last row, the scatter adds zeros for a dropped
    assignment (``index_add``: a kept row gets its one value plus
    zeros, the same bits) and the gather's row is multiplied by the
    ``keep`` mask, as in the JAX package.  Nothing reads an index out
    of range, nothing synchronises with the host, and the shapes
    depend on the token count alone (so a ``meta`` prefill runs it).

``moe_ref`` is the dense oracle: every expert on every token, no drops.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.param import ParamDef

MIN_CAPACITY = 4


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def moe_defs(cfg: ModelConfig):
    m = cfg.moe
    d, E, f = cfg.d_model, m.n_experts, m.d_expert
    defs = {
        "router": ParamDef((d, E), (None, None), scale=0.02),
        "wg": ParamDef((E, d, f), ("experts", "embed", "ffn")),
        "wu": ParamDef((E, d, f), ("experts", "embed", "ffn")),
        "wd": ParamDef((E, f, d), ("experts", "ffn", "embed")),
    }
    if m.n_shared:
        defs["shared"] = layers.mlp_defs(cfg, m.n_shared * f)
    return defs


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: the k largest values in
    descending order and their indices, ties lowest index first."""
    ids = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    return x.gather(-1, ids), ids


def route(logits: torch.Tensor, cfg: ModelConfig):
    """logits (T, E) -> weights (T, k), ids (T, k), aux_loss (scalar)."""
    m = cfg.moe
    lf = logits.float()
    if m.router_mode == "softmax_topk":      # DeepSeek-V2
        probs = torch.softmax(lf, dim=-1)
        weights, ids = top_k(probs, m.top_k)
    else:                                     # Mixtral / Jamba: top-k, softmax
        top_logits, ids = top_k(lf, m.top_k)
        weights = torch.softmax(top_logits, dim=-1)
        probs = torch.softmax(lf, dim=-1)
    # switch-style load-balance loss: E * sum_e (frac dispatched_e * mean prob_e)
    dispatch = torch.zeros_like(probs).scatter_add_(
        1, ids, torch.ones_like(weights))
    frac = dispatch.mean(dim=0) / m.top_k
    aux = m.n_experts * torch.sum(frac * probs.mean(dim=0))
    return weights, ids, aux


def _positions(flat_ids: torch.Tensor, E: int, cap: int):
    """Position of each assignment within its expert's capacity buffer
    (a running count per expert in assignment order), and whether it
    fits."""
    oh = (flat_ids[:, None] == torch.arange(E, device=flat_ids.device)).long()
    pos = (oh.cumsum(dim=0) - 1).gather(1, flat_ids[:, None])[:, 0]
    return pos, pos < cap


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    return max(MIN_CAPACITY,
               math.ceil(n_tokens * m.top_k / m.n_experts * m.capacity_factor))


def _expert_ffn(cfg: ModelConfig, wg, wu, wd, xs):
    """xs: (E, C, d) -> (E, C, d), one gated MLP per expert."""
    cdt = getattr(torch, cfg.compute_dtype)
    xs = xs.to(cdt)
    h = F.silu(torch.bmm(xs, wg.to(cdt))) * torch.bmm(xs, wu.to(cdt))
    return torch.bmm(h, wd.to(cdt))


def dispatch_plan(router, x: torch.Tensor, cfg: ModelConfig):
    """Routing and capacity slots of the tokens x (T, d): (weights, ids,
    aux, pos, keep, cap), pos and keep over the T * k assignments."""
    logits = x.float() @ router.float()
    weights, ids, aux = route(logits, cfg)
    cap = capacity(x.shape[0], cfg)
    pos, keep = _positions(ids.reshape(-1), cfg.moe.n_experts, cap)
    return weights, ids, aux, pos, keep, cap


def _moe_body(router, wg, wu, wd, x: torch.Tensor, cfg: ModelConfig):
    """x: (T, d) -> (out (T, d), aux), the JAX body with one expert shard."""
    T, d = x.shape
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    weights, ids, aux, pos, keep, cap = dispatch_plan(router, x, cfg)
    flat_ids = ids.reshape(-1)                                  # (T*k,)
    x_rep = x.repeat_interleave(k, dim=0)                       # (T*k, d)
    row = flat_ids * cap + pos.clamp(max=cap - 1)               # in range
    buf = x.new_zeros((E * cap, d)).index_add_(
        0, row, torch.where(keep[:, None], x_rep, 0))
    y = _expert_ffn(cfg, wg, wu, wd, buf.view(E, cap, d))
    rows = y.reshape(E * cap, d).index_select(0, row) * keep[:, None]
    rows = rows.reshape(T, k, d)
    out = torch.sum(weights[..., None].to(rows.dtype) * rows, dim=1)
    return out.to(x.dtype), aux


# ---------------------------------------------------------------------------
# public apply
# ---------------------------------------------------------------------------

def moe_apply(p, x: torch.Tensor, cfg: ModelConfig):
    """p: the layer's flat dict ("router", "wg", ..., "shared.wg");
    x: (B, S, d) -> (out (B, S, d), aux loss scalar)."""
    B, S, d = x.shape
    m = cfg.moe
    y, aux = _moe_body(p["router"], p["wg"], p["wu"], p["wd"],
                       x.reshape(B * S, d), cfg)
    y = y.reshape(B, S, d)
    if m.n_shared:
        y = y + layers.mlp(_shared(p), x, cfg)
    return y, aux * m.router_aux_weight


def _shared(p):
    return {k[len("shared."):]: v for k, v in p.items()
            if k.startswith("shared.")}


# ---------------------------------------------------------------------------
# dense oracle: every expert on every token, no capacity drops
# ---------------------------------------------------------------------------

def moe_ref(p, x: torch.Tensor, cfg: ModelConfig):
    B, S, d = x.shape
    m = cfg.moe
    xf = x.reshape(-1, d)
    logits = xf.float() @ p["router"].float()
    weights, ids, aux = route(logits, cfg)
    cdt = getattr(torch, cfg.compute_dtype)
    xs = xf.to(cdt)
    h = F.silu(torch.einsum("td,edf->tef", xs, p["wg"].to(cdt)))
    h = h * torch.einsum("td,edf->tef", xs, p["wu"].to(cdt))
    y_all = torch.einsum("tef,efd->ted", h, p["wd"].to(cdt))   # (T, E, d)
    sel = y_all.gather(1, ids[:, :, None].expand(-1, -1, d))   # (T, k, d)
    y = torch.sum(weights[..., None].to(sel.dtype) * sel, dim=1)
    y = y.reshape(B, S, d).to(x.dtype)
    if m.n_shared:
        y = y + layers.mlp(_shared(p), x, cfg)
    return y, aux * m.router_aux_weight
