"""Multi-tensor fused optimizer engine, single device.

A port of ``repro.core.multi_tensor`` (sharding is not ported yet).
The parameter dict is packed into dtype-bucketed flat buffers; one
``chunk_sumsq`` pass per bucket gives every global and per-tensor
squared norm, and one ``fused_update`` pass per bucket applies momentum
and the update — 2 kernel launches per bucket and step
for sngm, sngm_per_tensor and msgd, 3 for lars.  LAMB runs
``adam_update`` (both moments, the direction and its norm partials) and
``scale_apply`` (trust ratio, lr and apply): 2 launches per bucket and
step.

Clipping, as the chain compiler places it (``core/transform.py``):

  * a clip before the kind's stages (``clip=``) is a round of its own:
    one ``chunk_sumsq`` of the raw gradients per bucket, then the
    interpreter's clip expression leaf by leaf (``_clip_tree_round``) or
    on the flat buffers (``_clip_flats_round``): one launch more, and a
    clipped msgd skips its norm pass (the clip reports the norm);
  * a trailing clip (``suffix_clip=``, after the schedule) defers the
    apply: ``fused_update(apply=False)`` writes the f32 direction, the
    host forms ``cscale = clip / max(lr * ||direction||, clip)`` on the
    device, and one ``scale_apply`` per bucket applies
    ``p - lr * (cscale * direction)``: one launch more.

Numerics are bitwise those of the plain optimizer path (``core.optim``
with ``fused=None``) because both share one reduction order:
``leaf_sumsq`` sums CHUNK-row partials (``ref.row_sum``) and folds them
pairwise (``_fold_sum``); every segment starts on a CHUNK boundary, so
the kernels' row partials are the same numbers in the same order.

Leaf order is the JAX tree's.  ``jax.tree_util`` walks dict keys sorted
at every level, so "blocks.*" comes before "embed" before "final_norm",
and global norms add per-leaf values one after the other in that order.
The port's ``{dotted.path: Tensor}`` dicts keep insertion order, so
``leaf_order`` sorts the paths the way JAX does and every sum below
walks that order.

Residency: ``FlatOptState`` keeps params and f32 momentum (LAMB: the
two f32 moments; an EMA stage: its f32 shadow) as flat buffers across
steps, and the kernels (the EMA advance: plain PyTorch) update them in
place, where the JAX package donates them to
``input_output_aliases``.  A state that has
been stepped must not be used again (its buffers now hold the new
values), as a donated JAX state may not.  ``FlatOptState.params`` gives
the parameters as views into ``p_flats``, so the model reads them without
a second copy.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.fused_lars.ref import lars_sqnorm_ref
from repro_torch.kernels.multi_tensor import ops as _ops
from repro_torch.kernels.multi_tensor.ref import CHUNK, TILE, chunk_sumsq_ref

Tree = Dict[str, torch.Tensor]
LAMB_FORM = ("lamb", 0, 2)      # the JAX package's form for a clip-free LAMB


def leaf_order(paths) -> List[str]:
    """Dotted paths in the JAX tree's leaf order (keys sorted per level)."""
    return sorted(paths, key=lambda p: tuple(p.split(".")))


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    return [tree[k] for k in leaf_order(tree)]


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


# ---------------------------------------------------------------------------
# packing accounting
# ---------------------------------------------------------------------------

_PACKED = {"bytes": 0, "buffers": 0}


def _record_packed(flats: Sequence[torch.Tensor]) -> None:
    for f in flats:
        _PACKED["bytes"] += f.numel() * f.element_size()
        _PACKED["buffers"] += 1


@contextlib.contextmanager
def count_packed_bytes():
    """Count bytes packed into flat buffers inside the block.  A resident
    step fed ``FlatGrads`` (what the train step accumulates) packs
    nothing, fed a gradient dict it packs the gradients; the per-step
    path re-packs params, grads and momentum."""
    start = dict(_PACKED)
    box = {"bytes": 0, "buffers": 0}
    try:
        yield box
    finally:
        box["bytes"] = _PACKED["bytes"] - start["bytes"]
        box["buffers"] = _PACKED["buffers"] - start["buffers"]


# ---------------------------------------------------------------------------
# canonical chunked reduction (shared with the plain optimizer path)
# ---------------------------------------------------------------------------

def _fold_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum a 1-D f32 tensor by explicit pairwise halving (odd lengths get
    one zero appended first), the JAX package's fixed association."""
    n = x.shape[0]
    while n > 1:
        if n % 2:
            x = torch.cat([x, x.new_zeros(1)])
            n += 1
        x = x[:n // 2] + x[n // 2:]
        n //= 2
    return x[0]


def leaf_sumsq(x: torch.Tensor) -> torch.Tensor:
    """Sum of squares of one tensor, f32, in the engine's order: CHUNK-row
    partials, then a pairwise fold.  A size-0 leaf gives 0.0 (one zero
    chunk), matching its empty segment.  The rows are those the per-leaf
    LARS kernel sums (``lars_sqnorm_ref``)."""
    return _fold_sum(lars_sqnorm_ref(x))


def tree_squared_norm(tree: Tree) -> torch.Tensor:
    """Sum of squared entries of a whole dict, f32, leaves added in the
    JAX tree's order."""
    return sum(leaf_sumsq(x) for x in tree_leaves(tree))


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(tree_squared_norm(tree))


# ---------------------------------------------------------------------------
# layout: dtype buckets of chunk-aligned segments
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Segment:
    """One leaf's slice of its bucket buffer ([offset, offset+size) holds
    the flattened leaf; the segment is padded out to chunk_hi*CHUNK)."""
    index: int                  # position in the JAX leaf order
    path: str
    offset: int                 # element offset, always a CHUNK multiple
    size: int
    shape: Tuple[int, ...]
    dtype: torch.dtype
    chunk_lo: int               # [chunk_lo, chunk_hi) partial-row range
    chunk_hi: int


@dataclasses.dataclass(frozen=True)
class Bucket:
    dtype: torch.dtype
    segments: Tuple[Segment, ...]
    n_elems: int                # padded buffer length, TILE multiple
    n_chunks: int


@dataclasses.dataclass(frozen=True)
class TreeLayout:
    paths: Tuple[str, ...]      # in the JAX leaf order
    buckets: Tuple[Bucket, ...]

    @property
    def n_leaves(self) -> int:
        return len(self.paths)


def build_layout(tree: Tree) -> TreeLayout:
    """Static (shape/dtype-only) bucketing of a dict.  Leaves keep their
    JAX-order position within a bucket; buckets are ordered by dtype
    name."""
    paths = tuple(leaf_order(tree))
    by_dtype: Dict[str, List[int]] = {}
    for i, path in enumerate(paths):
        by_dtype.setdefault(dtype_name(tree[path].dtype), []).append(i)
    buckets = []
    for dname in sorted(by_dtype):
        segs, off = [], 0
        for i in by_dtype[dname]:
            leaf = tree[paths[i]]
            size = leaf.numel()
            n_chunks = max(1, -(-size // CHUNK))
            segs.append(Segment(index=i, path=paths[i], offset=off, size=size,
                                shape=tuple(leaf.shape), dtype=leaf.dtype,
                                chunk_lo=off // CHUNK,
                                chunk_hi=off // CHUNK + n_chunks))
            off += n_chunks * CHUNK
        n_elems = -(-off // TILE) * TILE
        buckets.append(Bucket(dtype=getattr(torch, dname), segments=tuple(segs),
                              n_elems=n_elems, n_chunks=n_elems // CHUNK))
    return TreeLayout(paths=paths, buckets=tuple(buckets))


def zeros_flats(layout: TreeLayout, dtype: Optional[torch.dtype] = None,
                device=None) -> List[torch.Tensor]:
    """One zero buffer per bucket, in the bucket dtype or ``dtype``."""
    return [torch.zeros(b.n_elems, dtype=dtype or b.dtype, device=device)
            for b in layout.buckets]


def flatten(tree: Tree, layout: TreeLayout,
            cast_to: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """Pack a dict into one new flat buffer per bucket (zero padding);
    ``cast_to`` overrides the buffer dtype (momentum is always f32)."""
    if set(tree) != set(layout.paths):
        raise ValueError("tree keys do not match the layout's paths")
    device = tree[layout.paths[0]].device if layout.paths else None
    flats = zeros_flats(layout, cast_to, device)
    for b, flat in zip(layout.buckets, flats):
        for s in b.segments:
            flat[s.offset:s.offset + s.size] = tree[s.path].reshape(-1)
    _record_packed(flats)
    return flats


def unflatten(flats: Sequence[torch.Tensor], layout: TreeLayout) -> Tree:
    """Inverse of ``flatten``: every leaf is a view into its buffer (no
    copy), keyed in the JAX leaf order."""
    out = {}
    for b, flat in zip(layout.buckets, flats):
        for s in b.segments:
            out[s.path] = flat[s.offset:s.offset + s.size].view(s.shape)
    return {p: out[p] for p in layout.paths}


def _segment_sums(partials: torch.Tensor, bucket: Bucket) -> List[torch.Tensor]:
    """Per-chunk partials -> one scalar per segment, the same fold as
    ``leaf_sumsq``'s last step."""
    return [_fold_sum(partials[s.chunk_lo:s.chunk_hi]) for s in bucket.segments]


def _per_chunk(bucket: Bucket, seg_vals: Sequence[torch.Tensor],
               fill: float = 0.0) -> torch.Tensor:
    """Per-segment scalars -> the (n_chunks,) f32 coefficient array the
    update kernel reads (tail-padding chunks get ``fill``)."""
    pieces = [v.reshape(1).float().expand(s.chunk_hi - s.chunk_lo)
              for s, v in zip(bucket.segments, seg_vals)]
    used = bucket.segments[-1].chunk_hi if bucket.segments else 0
    if bucket.n_chunks > used:
        dev = pieces[0].device if pieces else None
        pieces.append(torch.full((bucket.n_chunks - used,), fill,
                                 dtype=torch.float32, device=dev))
    return torch.cat(pieces)


def _leaf_values(parts_per_bucket, layout: TreeLayout) -> List[torch.Tensor]:
    """Fold per-chunk partials to one scalar per leaf, in the JAX leaf
    order (the order every canonical reduction sums in)."""
    out: List[Optional[torch.Tensor]] = [None] * layout.n_leaves
    for b, parts in zip(layout.buckets, parts_per_bucket):
        for s, v in zip(b.segments, _segment_sums(parts, b)):
            out[s.index] = v
    return out


# ---------------------------------------------------------------------------
# flat-buffer-resident optimizer state
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FlatOptState:
    """Params (bucket dtype) and the f32 optimizer slots kept as flat
    buffers, one per layout bucket.  The momentum kinds carry their
    momentum in ``u_flats``; LAMB (``form`` ``("lamb", n_prefix, 2)``)
    carries its first and second moments in ``m_flats``/``v_flats``
    instead, and ``u_flats`` is empty.  A segment-plan optimizer's state
    has the form ``("chain", slots)``, slots tagging each chain stage's
    state ("empty", "trace", "sched", "adam", "ema"), as in the JAX
    package; ``e_flats`` holds one tuple of per-bucket f32 shadow
    buffers per ``ema_params`` stage, in stage order (empty without
    one).  The buffers are the parameters' single owner; ``params``,
    ``momentum``, ``moments`` and ``ema_views`` are views into them."""
    step: int
    p_flats: Tuple[torch.Tensor, ...]
    u_flats: Tuple[torch.Tensor, ...]
    layout: TreeLayout
    m_flats: Tuple[torch.Tensor, ...] = ()
    v_flats: Tuple[torch.Tensor, ...] = ()
    e_flats: Tuple[Tuple[torch.Tensor, ...], ...] = ()
    form: Any = "momentum"

    @property
    def params(self) -> Tree:
        return unflatten(self.p_flats, self.layout)

    @property
    def momentum(self) -> Tree:
        return unflatten(self.u_flats, self.layout)

    @property
    def moments(self) -> Tuple[Tree, Tree]:
        """(m, v) views of the Adam moments (f32)."""
        return (unflatten(self.m_flats, self.layout),
                unflatten(self.v_flats, self.layout))

    @property
    def ema_views(self) -> Tuple[Tree, ...]:
        """One f32 shadow-parameter view per resident EMA stage."""
        return tuple(unflatten(e, self.layout) for e in self.e_flats)


def init_flat_state(params: Tree, form: Any = "momentum") -> FlatOptState:
    """Params packed once, momentum zeros (f32), on the params' device."""
    layout = build_layout(params)
    p_flats = flatten(params, layout)
    device = p_flats[0].device if p_flats else None
    return FlatOptState(step=0, p_flats=tuple(p_flats),
                        u_flats=tuple(zeros_flats(layout, torch.float32, device)),
                        layout=layout, form=form)


def init_flat_adam_state(params: Tree, form: Any = LAMB_FORM) -> FlatOptState:
    """LAMB's resident state: params packed once, both moments zeros (f32)
    in distinct buffers (the kernel updates each in place), no momentum
    slot."""
    layout = build_layout(params)
    p_flats = flatten(params, layout)
    device = p_flats[0].device if p_flats else None
    return FlatOptState(step=0, p_flats=tuple(p_flats), u_flats=(),
                        layout=layout,
                        m_flats=tuple(zeros_flats(layout, torch.float32, device)),
                        v_flats=tuple(zeros_flats(layout, torch.float32, device)),
                        form=form)


# elements of a bucket the EMA advance takes at a time: it bounds the f32
# temporary the advance needs (256 MiB) on a multi-GB bucket
EMA_SLICE = 1 << 26


def init_ema_flats(params: Tree, layout: TreeLayout
                   ) -> Tuple[torch.Tensor, ...]:
    """Resident shadow-parameter buffers for ONE ``ema_params`` stage: the
    params packed into new f32 buffers (never views of ``p_flats``), as
    the interpreter's ``ema_params`` init copies them leaf by leaf."""
    return tuple(flatten(params, layout, cast_to=torch.float32))


def ema_flats_update(e_flats: Sequence[torch.Tensor],
                     p_flats: Sequence[torch.Tensor],
                     decay: float) -> Tuple[torch.Tensor, ...]:
    """One EMA advance on the resident buffers, in place and elementwise
    (plain PyTorch, no kernel launch): ``e <- decay*e + (1-decay)*p`` on
    the params as they are now, so it runs before the step's update
    pass.  Two products and one add, each rounded (no ``lerp``, ``alpha``
    or ``addcmul``: those may fuse a multiply-add), the interpreter's
    expression bit for bit; zero padding stays zero.  A bucket goes
    ``EMA_SLICE`` elements at a time."""
    decay = float(decay)
    for e, pf in zip(e_flats, p_flats):
        for lo in range(0, e.numel(), EMA_SLICE):
            es = e[lo:lo + EMA_SLICE]
            es.mul_(decay)
            es.add_((1 - decay) * pf[lo:lo + EMA_SLICE].float())
    return tuple(e_flats)


@dataclasses.dataclass(frozen=True)
class FlatGrads:
    """Gradients already in the engine's per-bucket flat buffers."""
    flats: Tuple[torch.Tensor, ...]
    layout: TreeLayout

    @property
    def tree(self) -> Tree:
        return unflatten(self.flats, self.layout)


def check_grad_dtypes(grads: Tree, layout: TreeLayout) -> None:
    """The engine buckets by PARAM dtype, so gradients must match their
    parameter's dtype leaf for leaf."""
    if set(grads) != set(layout.paths):
        raise ValueError("gradient keys do not match the parameters'")
    for b in layout.buckets:
        for s in b.segments:
            if grads[s.path].dtype != s.dtype:
                raise ValueError(
                    f"multi_tensor fused path requires grads to match the "
                    f"parameter dtype per leaf; got grad "
                    f"{grads[s.path].dtype} for param {s.dtype} at {s.path}. "
                    f"Cast the gradients (or use fused=None, which promotes "
                    f"to f32).")


def require_matching_layout(grads: FlatGrads, layout: TreeLayout) -> None:
    if grads.layout != layout:
        raise ValueError("FlatGrads were packed with a different "
                         "TreeLayout than the resident state carries")


def _grad_flats(grads, layout: TreeLayout, clip: Optional[float]):
    """The gradient buffers a resident step feeds its kind, and the raw
    norm a clip round reports (None without a clip): ``FlatGrads`` as
    they are (clipped on the buffers), or a gradient dict clipped leaf by
    leaf and packed here."""
    if isinstance(grads, FlatGrads):
        require_matching_layout(grads, layout)
        if clip is None:
            return list(grads.flats), None
        return _clip_flats_round(grads.flats, layout, float(clip))
    check_grad_dtypes(grads, layout)
    gnorm = None
    if clip is not None:
        grads, gnorm = _clip_tree_round(grads, layout, float(clip))
    return flatten(grads, layout), gnorm


def resident_step(kind: str, grads, state: FlatOptState, *, lr, beta: float,
                  weight_decay: float = 0.0, eps: float = 1e-12,
                  trust: float = 0.001, clip: Optional[float] = None,
                  nesterov: bool = False) -> Tuple[FlatOptState, dict]:
    """The resident fast path: params and momentum stay in ``state``'s
    buffers and are updated in place; gradients come as ``FlatGrads``
    (used as they are) or as a dict (packed here).  ``clip`` runs the
    clip round first.  Returns ``(new_state, stats)``; the new state
    shares the buffers."""
    layout = state.layout
    g_flats, stat_gnorm = _grad_flats(grads, layout, clip)
    stats = multi_tensor_step_flat(
        kind, layout, state.p_flats, g_flats, state.u_flats, lr=lr,
        beta=beta, weight_decay=weight_decay, eps=eps, trust=trust,
        nesterov=nesterov, stat_gnorm=stat_gnorm)
    return dataclasses.replace(state, step=state.step + 1), stats


def resident_lamb_step(grads, state: FlatOptState, *, lr, b1: float,
                       b2: float, eps: float, weight_decay: float = 0.0,
                       trust_eps: float = 0.0, clip: Optional[float] = None
                       ) -> Tuple[FlatOptState, dict]:
    """LAMB's resident path: params and both moments stay in ``state``'s
    buffers and are updated in place; gradients and ``clip`` as in
    ``resident_step``.  Returns ``(new_state, stats)``; the new state
    shares the buffers."""
    layout = state.layout
    g_flats, stat_gnorm = _grad_flats(grads, layout, clip)
    stats = multi_tensor_lamb_step_flat(
        layout, state.p_flats, g_flats, state.m_flats, state.v_flats,
        count=state.step, lr=lr, b1=b1, b2=b2, eps=eps,
        weight_decay=weight_decay, trust_eps=trust_eps,
        stat_gnorm=stat_gnorm)
    return dataclasses.replace(state, step=state.step + 1), stats


# ---------------------------------------------------------------------------
# norms off flat buffers, and the clip rounds
# ---------------------------------------------------------------------------

def flat_squared_norm(flats: Sequence[torch.Tensor],
                      layout: TreeLayout) -> torch.Tensor:
    """The canonical squared norm straight off flat buffers with no kernel
    launch, as the JAX package takes it in jnp: CHUNK-row partials per
    bucket, per-segment pairwise folds, added in the JAX leaf order, so
    bitwise ``tree_squared_norm(unflatten(flats, layout))``."""
    return sum(_leaf_values([chunk_sumsq_ref(f) for f in flats], layout))


def flat_global_norm(flats: Sequence[torch.Tensor],
                     layout: TreeLayout) -> torch.Tensor:
    return torch.sqrt(flat_squared_norm(flats, layout))


def clip_scale(gnorm: torch.Tensor, clip: float) -> torch.Tensor:
    """``clip / max(gnorm, clip)`` in f32 on gnorm's device, the
    interpreter's clip factor (<= 1, no eps).  Both operands are tensors
    on one device, so the quotient is a true division (PyTorch's CUDA
    division by a CPU scalar multiplies by its reciprocal)."""
    c = torch.full_like(gnorm, clip)
    return c / torch.maximum(gnorm, c)


def clip_leaf(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """One leaf (or buffer) clipped: scaled in f32, cast back."""
    return (g.float() * scale).to(g.dtype)


def _clip_flats_round(g_flats, layout: TreeLayout, clip: float):
    """The clip round on gradients already in flat buffers: one raw
    ``chunk_sumsq`` launch per bucket, then the clip expression on the
    buffers (bitwise the leafwise clip: the scale is one scalar, and zero
    padding stays zero).  Returns (clipped_flats, raw_gnorm)."""
    parts = [_ops.chunk_sumsq(gf) for gf in g_flats]
    gnorm = torch.sqrt(sum(_leaf_values(parts, layout)))
    scale = clip_scale(gnorm, clip)
    return [clip_leaf(gf, scale) for gf in g_flats], gnorm


def _clip_tree_round(grads: Tree, layout: TreeLayout, clip: float,
                     cast_to: Optional[torch.dtype] = None):
    """The clip round on a gradient dict: pack the raw gradients (at
    ``cast_to``, f32 where an earlier chain stage promoted them), reduce
    their norm in one ``chunk_sumsq`` launch per bucket, then clip leaf
    by leaf.  Returns (clipped_grads, raw_gnorm)."""
    parts = [_ops.chunk_sumsq(gf) for gf in flatten(grads, layout, cast_to)]
    gnorm = torch.sqrt(sum(_leaf_values(parts, layout)))
    scale = clip_scale(gnorm, clip)
    return {k: clip_leaf(g, scale) for k, g in grads.items()}, gnorm


# ---------------------------------------------------------------------------
# the engine step
# ---------------------------------------------------------------------------

KINDS = ("sngm_global", "sngm_per_tensor", "msgd", "lars")


def multi_tensor_step(kind: str, params: Tree, grads: Tree, momentum: Tree, *,
                      lr, beta: float, weight_decay: float = 0.0,
                      eps: float = 1e-12, trust: float = 0.001,
                      clip: Optional[float] = None,
                      nesterov: bool = False) -> Tuple[Tree, Tree, dict]:
    """One fused step over whole dicts: packs params, grads and momentum
    into new flat buffers, runs the engine and unpacks.  ``clip`` runs
    the clip round first.  Returns (new_params, new_momentum, stats); the
    inputs are left untouched."""
    layout = build_layout(params)
    check_grad_dtypes(grads, layout)
    stat_gnorm = None
    if clip is not None:
        grads, stat_gnorm = _clip_tree_round(grads, layout, float(clip))
    p_flats = flatten(params, layout)
    g_flats = flatten(grads, layout)
    u_flats = flatten(momentum, layout, cast_to=torch.float32)
    stats = multi_tensor_step_flat(
        kind, layout, p_flats, g_flats, u_flats, lr=lr, beta=beta,
        weight_decay=weight_decay, eps=eps, trust=trust, nesterov=nesterov,
        stat_gnorm=stat_gnorm)
    return unflatten(p_flats, layout), unflatten(u_flats, layout), stats


def multi_tensor_step_flat(kind: str, layout: TreeLayout,
                           p_flats: Sequence[torch.Tensor],
                           g_flats: Sequence[torch.Tensor],
                           u_flats: Sequence[torch.Tensor], *, lr,
                           beta: float, weight_decay: float = 0.0,
                           eps: float = 1e-12, trust: float = 0.001,
                           nesterov: bool = False,
                           suffix_clip: Optional[float] = None,
                           stat_gnorm: Optional[torch.Tensor] = None) -> dict:
    """The engine core over one (p, g, u) buffer triple per bucket; p and
    u are updated in place.  Returns the stats {grad_norm, lr,
    update_norm} (0-dim f32 tensors, left on the buffers' device).

    ``stat_gnorm`` is the raw norm a clip round before the kind reported;
    msgd takes it as its ``grad_norm`` and skips its norm pass (its
    coefficients need no norm).  ``suffix_clip`` compiles a trailing
    ``clip_by_global_norm``: pass 2 defers the apply and writes the f32
    direction, whose norm times the lr is the norm the interpreter's
    clip sees, and pass 3 (``scale_apply``) applies the clipped step.
    Against the interpreter this associates ``lr * ||u||`` where it folds
    ``||lr * u||`` and applies ``lr * (cscale * u)`` where it applies
    ``(lr * u) * cscale``: a few ulp, as in the JAX package.  The stats
    follow the interpreter's left-to-right merge: the trailing clip
    reports the norm of its input (``lr * ||u||``) as ``grad_norm``, and
    ``update_norm`` stays the schedule's pre-lr norm."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; expected one of {KINDS}")
    wd = float(weight_decay)

    # ---- pass 1: squared-norm partials per bucket ----------------------
    # sngm/msgd norm the decayed gradient (g + wd*w, inside the kernel);
    # lars needs raw ||g|| and ||w|| per tensor instead.  msgd runs it for
    # the grad_norm stat only, so not when a clip reports that stat
    g_parts, w_parts = [], []
    if not (kind == "msgd" and (stat_gnorm is not None
                                or suffix_clip is not None)):
        for pf, gf in zip(p_flats, g_flats):
            if kind == "lars":
                g_parts.append(_ops.chunk_sumsq(gf))
                w_parts.append(_ops.chunk_sumsq(pf))
            else:
                g_parts.append(_ops.chunk_sumsq(gf, pf, wd=wd))

    # per-segment and global sums, in the JAX leaf order
    if g_parts:
        gsq_by_leaf = _leaf_values(g_parts, layout)
        gnorm = torch.sqrt(sum(gsq_by_leaf))
    else:
        gsq_by_leaf, gnorm = None, stat_gnorm
    wsq_by_leaf = _leaf_values(w_parts, layout) if kind == "lars" else None

    # ---- coefficients --------------------------------------------------
    lr = torch.as_tensor(lr, dtype=torch.float32).cpu()
    cast_g_first = False
    if kind == "sngm_global":
        inv = 1.0 / (gnorm + eps)
        a_chunks = [inv.reshape(1).expand(b.n_chunks).contiguous()
                    for b in layout.buckets]
        c = lr
    elif kind == "sngm_per_tensor":
        a_chunks = [
            _per_chunk(b, [1.0 / (torch.sqrt(gsq_by_leaf[s.index]) + eps)
                           for s in b.segments])
            for b in layout.buckets]
        c = lr
    elif kind == "msgd":
        a_chunks = [torch.ones(b.n_chunks, dtype=torch.float32,
                               device=pf.device)
                    for b, pf in zip(layout.buckets, p_flats)]
        c = lr
    else:  # lars
        def local_lr(s):
            wn = torch.sqrt(wsq_by_leaf[s.index])
            gn = torch.sqrt(gsq_by_leaf[s.index])
            local = trust * wn / (gn + wd * wn + eps)
            return lr.to(wn.device) * torch.where(wn > 0, local, 1.0)
        a_chunks = [_per_chunk(b, [local_lr(s) for s in b.segments])
                    for b in layout.buckets]
        c = torch.tensor(1.0, dtype=torch.float32)
        cast_g_first = True

    # ---- pass 2: fused momentum + apply per bucket ---------------------
    kw = dict(beta=beta, wd=wd, cast_g_first=cast_g_first, nesterov=nesterov)
    if suffix_clip is None:
        usq_parts = [_ops.fused_update(pf, gf, uf, ac, c, **kw)
                     for pf, gf, uf, ac in zip(p_flats, g_flats, u_flats,
                                               a_chunks)]
        unorm = torch.sqrt(sum(_leaf_values(usq_parts, layout)))
        return {"grad_norm": gnorm, "lr": lr, "update_norm": unorm}
    deferred = [_ops.fused_update(pf, gf, uf, ac, c, apply=False, **kw)
                for pf, gf, uf, ac in zip(p_flats, g_flats, u_flats, a_chunks)]
    unorm = torch.sqrt(sum(_leaf_values([q for _, q in deferred], layout)))

    # ---- pass 3 (trailing clip): rescale the direction and apply -------
    # p <- p - lr * (cscale * direction); the clip's factor stays on the
    # device, read by the kernel as its per-row coefficient
    snorm = lr * unorm
    cscale = clip_scale(snorm, float(suffix_clip))
    for b, pf, (eff, _) in zip(layout.buckets, p_flats, deferred):
        _ops.scale_apply(pf, eff, cscale.reshape(1).expand(b.n_chunks)
                         .contiguous(), lr)
    return {"grad_norm": snorm, "lr": lr, "update_norm": unorm}


# ---------------------------------------------------------------------------
# the LAMB engine step
# ---------------------------------------------------------------------------

def bias_corrections(count: int, b1: float, b2: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adam's ``1 - b**t`` with ``t = count + 1`` in f32, as the JAX
    package computes them (``t`` cast to f32, ``b`` a weakly typed float
    rounded to f32): 0-dim f32 CPU tensors."""
    t = torch.tensor(count, dtype=torch.float32) + 1.0
    return (1 - torch.tensor(b1, dtype=torch.float32) ** t,
            1 - torch.tensor(b2, dtype=torch.float32) ** t)


def trust_ratio(wsq: torch.Tensor, usq: torch.Tensor,
                trust_eps: float) -> torch.Tensor:
    """LAMB's per-tensor ratio ``||w|| / (||u|| + eps)``, 1 where either
    norm is zero, from the two squared norms."""
    wn, un = torch.sqrt(wsq), torch.sqrt(usq)
    return torch.where((wn > 0) & (un > 0), wn / (un + trust_eps), 1.0)


def multi_tensor_lamb_step(params: Tree, grads: Tree, count: int, m: Tree,
                           v: Tree, *, lr, b1: float, b2: float, eps: float,
                           weight_decay: float = 0.0, trust_eps: float = 0.0,
                           clip: Optional[float] = None
                           ) -> Tuple[Tree, Tree, Tree, dict]:
    """One fused LAMB step over whole dicts (the per-step packing path):
    packs params, grads and both moments into new flat buffers, runs the
    engine and unpacks.  ``count`` is the step before this one; ``clip``
    runs the clip round first.  Returns (new_params, new_m, new_v,
    stats); the inputs are left untouched."""
    layout = build_layout(params)
    check_grad_dtypes(grads, layout)
    stat_gnorm = None
    if clip is not None:
        grads, stat_gnorm = _clip_tree_round(grads, layout, float(clip))
    p_flats = flatten(params, layout)
    g_flats = flatten(grads, layout)
    m_flats = flatten(m, layout, cast_to=torch.float32)
    v_flats = flatten(v, layout, cast_to=torch.float32)
    stats = multi_tensor_lamb_step_flat(
        layout, p_flats, g_flats, m_flats, v_flats, count=count, lr=lr,
        b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, trust_eps=trust_eps,
        stat_gnorm=stat_gnorm)
    return (unflatten(p_flats, layout), unflatten(m_flats, layout),
            unflatten(v_flats, layout), stats)


def multi_tensor_lamb_step_flat(layout: TreeLayout,
                                p_flats: Sequence[torch.Tensor],
                                g_flats: Sequence[torch.Tensor],
                                m_flats: Sequence[torch.Tensor],
                                v_flats: Sequence[torch.Tensor], *,
                                count: int, lr, b1: float, b2: float,
                                eps: float, weight_decay: float = 0.0,
                                trust_eps: float = 0.0,
                                stat_gnorm: Optional[torch.Tensor] = None
                                ) -> dict:
    """The LAMB engine core: per bucket, ``adam_update`` advances m and v
    in place and forms the direction with its row partials (u, p, g);
    the host folds them per segment into the trust ratios; then
    ``scale_apply`` applies ``p <- p - lr*(ratio*u)`` in place.  The
    stats are the raw gradient norm (``stat_gnorm`` where a clip round
    reported it), the lr, and the norm of the trust-scaled direction
    before the lr (the plain path's ``update_norm``).  ``eps`` must be
    > 0 (zero padding must give a zero direction)."""
    assert eps > 0.0, "fused lamb requires adam eps > 0 (pad invariance)"
    wd = float(weight_decay)
    bc1, bc2 = bias_corrections(count, b1, b2)

    # ---- pass 1: both moments, the direction and three partial sets ----
    u_flats, usq_parts, psq_parts, gsq_parts = [], [], [], []
    for pf, gf, mf, vf in zip(p_flats, g_flats, m_flats, v_flats):
        ud, usq, psq, gsq = _ops.adam_update(pf, gf, mf, vf, bc1, bc2, b1=b1,
                                             b2=b2, eps=eps, wd=wd)
        u_flats.append(ud)
        usq_parts.append(usq)
        psq_parts.append(psq)
        gsq_parts.append(gsq)
    gnorm = (stat_gnorm if stat_gnorm is not None
             else torch.sqrt(sum(_leaf_values(gsq_parts, layout))))

    # ---- per-segment trust ratios --------------------------------------
    usq_by_leaf = _leaf_values(usq_parts, layout)
    wsq_by_leaf = _leaf_values(psq_parts, layout)
    a_chunks = [_per_chunk(b, [trust_ratio(wsq_by_leaf[s.index],
                                           usq_by_leaf[s.index], trust_eps)
                               for s in b.segments])
                for b in layout.buckets]

    # ---- pass 2: trust-scale + apply -----------------------------------
    lr = torch.as_tensor(lr, dtype=torch.float32).cpu()
    ssq_parts = [_ops.scale_apply(pf, ud, ac, lr)
                 for pf, ud, ac in zip(p_flats, u_flats, a_chunks)]
    unorm = torch.sqrt(sum(_leaf_values(ssq_parts, layout)))
    return {"grad_norm": gnorm, "lr": lr, "update_norm": unorm}
