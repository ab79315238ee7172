"""Optimizers: SNGM (the paper, Algorithm 1) and its baselines, built as
gradient-transform chains.

A port of ``repro.core.optim``.  Every builder composes a chain of
``core/transform.py`` stages and compiles it with ``compile_chain``, as
the JAX package does, so a user's chain and a named optimizer take one
road to the engine:

    sngm   add_decayed_weights . normalize_by_global_norm . trace
           . scale_by_schedule             (kind sngm_global; per_tensor:
                                            normalize_per_tensor)
    sngd   sngm with beta = 0
    msgd   add_decayed_weights . trace . scale_by_schedule
    lars   trust_ratio . scale_by_schedule . trace
    lamb   scale_by_adam . add_decayed_weights . scale_by_trust_ratio
           . scale_by_schedule

``compile_chain`` matches those shapes, optionally led by
``clip_by_global_norm``, onto the kind-level optimizers here
(``_kind_optimizer``, ``_lamb_optimizer``); other chains with a fusible
tail run as segment plans (``_plan_optimizer``: plain prefix stages, a
mid-chain clip folded into the tail's clip round, a trailing clip as the
deferred-apply pass), and the rest on the chain interpreter.

``fused=None`` runs the plain path (``_plain_kind_step``, the JAX
package's ``_jnp_kind_step``; for lamb ``_plain_lamb_step``, the chain
interpreter's stages); ``fused="multi_tensor"`` runs the engine in
``core/multi_tensor.py`` (kernel launches per step and dtype bucket:
sngm, msgd, nesterov sngm and lamb 2, lars 3, one more for a clip
round or a trailing clip), bitwise equal to the plain path;
``fused="per_leaf"`` (sngm with the global norm, sngd and lars) runs one
kernel per tensor (``_per_leaf_kind_step``: 1 launch per leaf for sngm,
3 for lars), the baseline the engine is measured against, bitwise equal
to the plain path in fp32.  ``sngm(ema_decay=)`` appends an
``ema_params`` stage: a segment plan whose shadow params are resident
f32 slots on the engine (``FlatOptState.e_flats``, advanced in plain
PyTorch, no launch), the interpreter otherwise.

State forms: with ``fused="multi_tensor"``, ``init`` returns a resident
``FlatOptState`` whose flat buffers own the parameters (a segment plan's
has the form ``("chain", slots)``); an ``OptState`` fed to the engine
takes the per-step packing route, and a ``FlatOptState`` fed to the
plain path reads its views and returns an ``OptState`` (lamb:
``LambState``).  Interpreter-run chains carry a ``ChainOptState``.
``TrainState`` is the unified state the train step threads: on the
resident path ``params`` is None and the buffers are the single
parameter copy.  A stepped resident state's buffers hold the new values
(the kernels update them in place), and so do a per-leaf step's
parameter and momentum tensors: only the returned state may be used.
``to_pytree`` / ``from_pytree`` convert between every state form and
the JAX package's pytree forms (``OptState``, ``ChainOptState``), which
checkpoints hold; ``OptimizerSpec`` is an optimizer's JSON identity,
saved beside them in ``train_meta.json``.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import transform as T
from repro_torch.core.multi_tensor import (
    LAMB_FORM, FlatGrads, FlatOptState, _clip_flats_round, _clip_tree_round,
    bias_corrections, build_layout, clip_leaf, clip_scale, ema_flats_update,
    flat_global_norm, flatten, global_norm, init_ema_flats,
    init_flat_adam_state, init_flat_state, leaf_order, leaf_sumsq,
    multi_tensor_lamb_step_flat,
    multi_tensor_step, multi_tensor_step_flat, require_matching_layout,
    resident_lamb_step, resident_step, trust_ratio)
from repro_torch.core.schedules import Schedule, make_schedule
from repro_torch.kernels.multi_tensor.ref import weak_scalar

Tree = Dict[str, torch.Tensor]


class OptState(NamedTuple):
    step: int
    momentum: Tree             # f32, mirrors params


class LambState(NamedTuple):
    """LAMB's dict-form state: the step and both f32 Adam moments (the JAX
    interpreter's ``ChainOptState`` holds the same in ``inner[0]``, and
    the step again as the schedule's count in ``inner[-1]``).  ``form``
    is the resident state's ``("lamb", n_prefix, n_mid)``: where the
    Adam stage sits in the chain, which ``to_pytree`` needs to rebuild
    the interpreter's state."""
    step: int
    m: Tree
    v: Tree
    form: Any = LAMB_FORM


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """init/step pair.  ``step(grads, state, params)`` returns
    (new_params, new_state, stats); ``new_params`` is None on the
    resident path, whose buffers own the parameters.  ``kind`` is the
    engine kind a compiled chain matched (the whole chain's or a segment
    plan's tail), ``plan`` the chain compiler's ``SegmentPlan`` (None
    outside ``compile_chain`` and under ``interpret=True``)."""
    name: str
    init: Callable[[Tree], Any]
    step: Callable[[Any, Any, Optional[Tree]], Tuple[Optional[Tree], Any, dict]]
    kind: Optional[str] = None
    plan: Any = None

    def init_state(self, params: Tree) -> "TrainState":
        return TrainState.wrap(params, self.init(params))

    def step_state(self, grads, state: "TrainState") -> Tuple["TrainState", dict]:
        new_p, new_s, stats = self.step(grads, state.opt_state, state.params)
        return TrainState.wrap(new_p, new_s), stats


@dataclasses.dataclass(frozen=True)
class TrainState:
    """Parameters (or their resident flat-buffer owner) and optimizer
    slots.  On the resident path ``params`` is None and
    ``opt_state.p_flats`` are the only parameter copy."""
    params: Optional[Tree]
    opt_state: Any

    @classmethod
    def wrap(cls, params: Optional[Tree], opt_state: Any) -> "TrainState":
        """A resident ``FlatOptState`` owns the parameters (the dict is
        dropped); any other state form carries them."""
        if isinstance(opt_state, FlatOptState):
            return cls(params=None, opt_state=opt_state)
        return cls(params=params, opt_state=opt_state)

    @property
    def step(self) -> int:
        return self.opt_state.step

    @property
    def params_view(self) -> Tree:
        """The parameter dict: ``params`` itself, or views into the
        resident flat buffers."""
        if self.params is not None:
            return self.params
        return self.opt_state.params


def _zeros_f32(params: Tree) -> Tree:
    return {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
            for k, v in params.items()}


def _init(params: Tree) -> OptState:
    # momentum is always fp32, independent of parameter storage dtype
    return OptState(step=0, momentum=_zeros_f32(params))


# ---------------------------------------------------------------------------
# state forms: resident <-> pytree (what a checkpoint holds)
# ---------------------------------------------------------------------------

def _chain_state_of_lamb(form, step: int, m: Tree, v: Tree) -> "T.ChainOptState":
    """The interpreter's ChainOptState for LAMB, from its ``("lamb",
    n_prefix, n_mid)`` form: stateless stages around the Adam stage, the
    schedule last, every counter equal to the step (they advance in
    lockstep by construction)."""
    _, n_prefix, n_mid = form
    inner = ((T.EmptyState(),) * n_prefix
             + (T.ScaleByAdamState(count=step, m=m, v=v),)
             + (T.EmptyState(),) * n_mid
             + (T.ScaleByScheduleState(count=step),))
    return T.ChainOptState(step=step, inner=inner)


def _chain_state_of_chain_form(state: FlatOptState) -> "T.ChainOptState":
    """The interpreter's ChainOptState for a segment-plan resident state:
    the ``("chain", slots)`` form tags every stage's state, the momentum
    and moment views come from the resident buffers, the EMA shadows from
    ``e_flats`` (in stage order), and every counter equals the step."""
    _, slots = state.form
    emas = iter(state.ema_views)
    inner = []
    for tag in slots:
        if tag == "trace":
            inner.append(T.TraceState(momentum=state.momentum))
        elif tag == "sched":
            inner.append(T.ScaleByScheduleState(count=state.step))
        elif tag == "adam":
            m, v = state.moments
            inner.append(T.ScaleByAdamState(count=state.step, m=m, v=v))
        elif tag == "ema":
            inner.append(T.EmaParamsState(ema=next(emas)))
        else:
            inner.append(T.EmptyState())
    return T.ChainOptState(step=state.step, inner=tuple(inner))


def to_pytree(state):
    """Any state form -> its pytree form, lossless, as the JAX package's
    ``to_pytree``: ``OptState`` (momentum dict) for the momentum kinds,
    the interpreter's ``ChainOptState`` for LAMB (resident, or the plain
    path's ``LambState``) and for segment-plan states.  ``OptState`` and
    ``ChainOptState`` pass through.  The result's tensors are the
    state's own (views into a resident state's buffers), not copies.
    This is what a checkpoint holds, keyed as the JAX package keys it."""
    if isinstance(state, LambState):
        return _chain_state_of_lamb(state.form, state.step, state.m, state.v)
    if not isinstance(state, FlatOptState):
        return state
    if isinstance(state.form, tuple) and state.form[0] == "chain":
        return _chain_state_of_chain_form(state)
    if state.m_flats:
        return _chain_state_of_lamb(state.form, state.step, *state.moments)
    return OptState(step=state.step, momentum=state.momentum)


def _lamb_form_of(state: "T.ChainOptState") -> Optional[Tuple[str, int, int]]:
    """``("lamb", n_prefix, n_mid)`` when the chain state has LAMB's shape
    (one Adam stage, the schedule last, every other stage stateless)."""
    adam_i = [i for i, s in enumerate(state.inner)
              if isinstance(s, T.ScaleByAdamState)]
    others_ok = all(isinstance(s, T.EmptyState)
                    for i, s in enumerate(state.inner)
                    if i not in adam_i and i != len(state.inner) - 1)
    if (len(adam_i) == 1 and others_ok
            and isinstance(state.inner[-1], T.ScaleByScheduleState)):
        return ("lamb", adam_i[0], len(state.inner) - adam_i[0] - 2)
    return None


def _flat_of_chain_state(state: "T.ChainOptState", params: Tree,
                         layout) -> FlatOptState:
    """General ChainOptState -> the segment-plan ``("chain", slots)``
    resident form: the momentum into ``u_flats`` or the Adam moments
    into ``m_flats``/``v_flats`` (a chain carrying both has no flat
    form), the EMA shadows into ``e_flats`` in stage order."""
    slots, traces, adams, emas = [], [], [], []
    for s in state.inner:
        if isinstance(s, T.TraceState):
            slots.append("trace")
            traces.append(s)
        elif isinstance(s, T.ScaleByScheduleState):
            slots.append("sched")
        elif isinstance(s, T.ScaleByAdamState):
            slots.append("adam")
            adams.append(s)
        elif isinstance(s, T.EmaParamsState):
            slots.append("ema")
            emas.append(s)
        elif isinstance(s, T.EmptyState):
            slots.append("empty")
        else:
            raise TypeError(
                f"from_pytree: no flat slot for chain stage state "
                f"{type(s).__name__}; only the canonical transform states "
                f"(trace/sched/adam/ema/stateless) have a flat form")
    if len(traces) > 1 or len(adams) > 1 or (traces and adams):
        raise TypeError(
            "from_pytree: only canonical single-momentum chain states have "
            "a flat form (at most one trace XOR one scale_by_adam); got "
            f"inner types {[type(s).__name__ for s in state.inner]}")

    def packed(tree):
        return tuple(flatten(tree, layout, cast_to=torch.float32))
    return FlatOptState(
        step=state.step, p_flats=tuple(flatten(params, layout)),
        u_flats=packed(traces[0].momentum) if traces else (), layout=layout,
        m_flats=packed(adams[0].m) if adams else (),
        v_flats=packed(adams[0].v) if adams else (),
        e_flats=tuple(packed(e.ema) for e in emas),
        form=("chain", tuple(slots)))


def from_pytree(state, params: Tree) -> FlatOptState:
    """Pytree form -> the resident ``FlatOptState``, lossless; a
    ``FlatOptState`` passes through and a ``LambState`` goes as its
    ``ChainOptState``.  ``params`` gives the layout and the parameter
    buffers.  A ChainOptState of LAMB's shape keeps the ``("lamb", ...)``
    form, any other canonical chain state takes the segment planner's
    ``("chain", slots)`` form, an ``OptState`` the momentum form.
    Per-stage counters are taken to equal the step, as the chain update
    keeps them.  The JAX package's ``mesh=`` is not taken (ROADMAP.md
    Queue A9)."""
    if isinstance(state, FlatOptState):
        return state
    if isinstance(state, LambState):
        state = to_pytree(state)
    layout = build_layout(params)
    if isinstance(state, T.ChainOptState):
        form = _lamb_form_of(state)
        if form is None:
            return _flat_of_chain_state(state, params, layout)
        adam = state.inner[form[1]]
        return FlatOptState(
            step=state.step, p_flats=tuple(flatten(params, layout)),
            u_flats=(), layout=layout,
            m_flats=tuple(flatten(adam.m, layout, cast_to=torch.float32)),
            v_flats=tuple(flatten(adam.v, layout, cast_to=torch.float32)),
            form=form)
    return FlatOptState(
        step=state.step, p_flats=tuple(flatten(params, layout)),
        u_flats=tuple(flatten(state.momentum, layout, cast_to=torch.float32)),
        layout=layout)


def lamb_state_of(state: "T.ChainOptState") -> LambState:
    """A ChainOptState of LAMB's shape -> the plain path's ``LambState``
    (the same tensors; the inverse of ``to_pytree`` on a LambState)."""
    form = _lamb_form_of(state)
    if form is None:
        raise TypeError(f"not a LAMB chain state: inner types "
                        f"{[type(s).__name__ for s in state.inner]}")
    adam = state.inner[form[1]]
    return LambState(state.step, adam.m, adam.v, form)


def _resolve_fused(fused: Optional[str],
                   allowed=("per_leaf", "multi_tensor")) -> Optional[str]:
    """The JAX package's check of the ``fused`` argument."""
    if fused is not None and fused not in allowed:
        raise ValueError(f"fused={fused!r}; expected one of {allowed} or None")
    return fused


def _decayed(grads: Tree, params: Tree, weight_decay: float) -> Tree:
    """PyTorch-SGD-style coupled weight decay: g <- g + wd * w (paper §5)."""
    if weight_decay == 0.0:
        return grads
    return {k: g + weak_scalar(weight_decay, params[k].dtype) * params[k]
            for k, g in grads.items()}


def _clip_tree(grads: Tree, clip: float):
    """The interpreter's clip_by_global_norm: the clipped gradient dict
    (scaled in f32, cast back per leaf) and the RAW norm."""
    raw = global_norm(grads)
    scale = clip_scale(raw, clip)
    return {k: clip_leaf(g, scale) for k, g in grads.items()}, raw


def _plain_kind_step(kind: str, grads: Tree, momentum: Tree, params: Tree, *,
                     lr, beta: float, weight_decay: float, eps: float,
                     trust: float, clip: Optional[float] = None,
                     nesterov: bool = False):
    """The plain step for one engine kind, expression for expression the
    JAX package's ``_jnp_kind_step``.  Returns (new_params, new_momentum,
    stats).  ``clip`` clips the gradients first; ``nesterov`` applies the
    update expression a second time with the fresh momentum; the
    momentum state stays the plain trace."""
    lr = torch.as_tensor(lr, dtype=torch.float32).cpu()
    raw_gnorm = None
    if clip is not None:
        grads, raw_gnorm = _clip_tree(grads, clip)
    if kind == "lars":
        def upd(v, g, w):
            g = g.float()
            wn = torch.sqrt(leaf_sumsq(w))
            gn = torch.sqrt(leaf_sumsq(g))
            local = trust * wn / (gn + weight_decay * wn + eps)
            # scalars (biases/norm scales, ||w|| ~ 0 at init) fall back to 1
            local = torch.where(wn > 0, local, 1.0)
            return beta * v + lr * local * (g + weak_scalar(weight_decay, w.dtype) * w)

        new_u = {k: upd(momentum[k], grads[k], params[k]) for k in params}
        out_u = ({k: upd(new_u[k], grads[k], params[k]) for k in params}
                 if nesterov else new_u)
        new_p = {k: (w - out_u[k]).to(w.dtype) for k, w in params.items()}
        gnorm = global_norm(grads)
    else:
        g = _decayed(grads, params, weight_decay)
        gnorm = global_norm(g)
        if kind == "sngm_global":
            inv = 1.0 / (gnorm + eps)

            def upd(u, gi):
                return beta * u + gi.float() * inv
        elif kind == "sngm_per_tensor":
            def upd(u, gi):
                n = torch.sqrt(leaf_sumsq(gi))
                return beta * u + gi.float() * (1.0 / (n + eps))
        else:  # msgd
            def upd(v, gi):
                return beta * v + gi.float()
        new_u = {k: upd(momentum[k], g[k]) for k in params}
        out_u = {k: upd(new_u[k], g[k]) for k in params} if nesterov else new_u
        new_p = {k: (w - lr * out_u[k]).to(w.dtype) for k, w in params.items()}
    if clip is not None and kind == "msgd":
        # a clipped msgd chain has no norm-emitting stage after the clip,
        # so the interpreter reports the RAW gradient norm
        gnorm = raw_gnorm
    stats = {"grad_norm": gnorm, "lr": lr, "update_norm": global_norm(out_u)}
    return new_p, new_u, stats


_PER_LEAF_KINDS = ("sngm_global", "lars")


def _per_leaf_kind_step(kind: str, grads: Tree, momentum: Tree, params: Tree,
                        *, lr, beta: float, weight_decay: float, eps: float,
                        trust: float):
    """The one-kernel-per-tensor path (the JAX package's
    ``_per_leaf_kind_step``): params and momentum are updated in place,
    leaf by leaf in the JAX tree's order.  The decay ``g + wd*w`` and
    SNGM's global norm stay plain ops outside the kernels, as in JAX."""
    from repro_torch.kernels.fused_lars.ops import lars_update
    from repro_torch.kernels.fused_sngm.ops import fused_sngm_tree
    lr = torch.as_tensor(lr, dtype=torch.float32).cpu()
    if kind == "sngm_global":
        g = _decayed(grads, params, weight_decay)
        gnorm = global_norm(g)
        inv = 1.0 / (gnorm + eps)
        new_p, new_u = fused_sngm_tree(params, g, momentum, inv, beta, lr)
    else:  # lars
        for k in leaf_order(params):
            lars_update(params[k], grads[k], momentum[k], lr, beta=beta,
                        wd=weight_decay, trust=trust, eps=eps)
        new_p, new_u = params, momentum
        gnorm = global_norm(grads)
    stats = {"grad_norm": gnorm, "lr": lr, "update_norm": global_norm(new_u)}
    return new_p, new_u, stats


def _kind_optimizer(kind: str, schedule: Schedule, *, beta: float,
                    weight_decay: float = 0.0, eps: float = 1e-12,
                    trust: float = 0.001, clip: Optional[float] = None,
                    nesterov: bool = False, fused: Optional[str] = None,
                    name: Optional[str] = None) -> Optimizer:
    """The Optimizer for one engine kind in the requested execution mode
    (``fused=None``, ``"multi_tensor"`` or ``"per_leaf"``), with the JAX
    package's refusals: ``compile_chain``'s target for a matched chain.
    ``clip`` is a leading ``clip_by_global_norm``: the clip round on the
    engine, the leafwise pre-scale on the plain path."""
    fused = _resolve_fused(fused)
    if fused == "per_leaf" and kind not in _PER_LEAF_KINDS:
        raise ValueError(f"fused='per_leaf' is not available for kind "
                         f"{kind!r}; only {_PER_LEAF_KINDS} have per-leaf "
                         f"kernels — use fused='multi_tensor'")
    if fused == "per_leaf" and clip is not None:
        raise ValueError("fused='per_leaf' has no clip round; use "
                         "fused='multi_tensor' for clip-prefixed chains")
    if fused == "per_leaf" and nesterov:
        raise ValueError("fused='per_leaf' has no nesterov variant; use "
                         "fused='multi_tensor' or fused=None for "
                         "trace(nesterov=True) chains")
    kw = dict(beta=beta, weight_decay=weight_decay, eps=eps, trust=trust,
              clip=clip, nesterov=nesterov)

    @torch.no_grad()
    def step_fn(grads, state, params):
        lr = schedule(state.step)
        if fused == "multi_tensor" and isinstance(state, FlatOptState):
            new_state, stats = resident_step(kind, grads, state, lr=lr, **kw)
            return None, new_state, stats
        if isinstance(grads, FlatGrads):
            grads = grads.tree
        if params is None:
            # a resident state on the plain path: read its buffer views
            params = state.params
        if fused == "multi_tensor":
            new_p, new_u, stats = multi_tensor_step(
                kind, params, grads, state.momentum, lr=lr, **kw)
        elif fused == "per_leaf":
            new_p, new_u, stats = _per_leaf_kind_step(
                kind, grads, state.momentum, params, lr=lr, beta=beta,
                weight_decay=weight_decay, eps=eps, trust=trust)
        else:
            new_p, new_u, stats = _plain_kind_step(
                kind, grads, state.momentum, params, lr=lr, **kw)
        return new_p, OptState(state.step + 1, new_u), stats

    init = init_flat_state if fused == "multi_tensor" else _init
    return Optimizer(name or kind, init, step_fn, kind=kind)


# ---------------------------------------------------------------------------
# LAMB: the Adam family (f32 m and v beside the params)
# ---------------------------------------------------------------------------

def _plain_lamb_step(grads: Tree, state: LambState, params: Tree, lr, *,
                     b1: float, b2: float, eps: float, weight_decay: float,
                     trust_eps: float, clip: Optional[float] = None):
    """The JAX chain interpreter's LAMB step, stage for stage:
    (``clip_by_global_norm``), ``scale_by_adam``
    (``repro/core/transform.py:290-317``), ``add_decayed_weights``
    (:161-176), ``scale_by_trust_ratio`` (:273-287), ``scale_by_schedule``
    (:320-337), then ``w - u`` in w's dtype; ``grad_norm`` is the raw
    gradient's norm (``optim.py:615-622``; the clip reports the same).
    Returns (new_params, new_state, stats)."""
    lr = torch.as_tensor(lr, dtype=torch.float32).cpu()
    if clip is not None:
        grads, gnorm = _clip_tree(grads, clip)
    else:
        gnorm = global_norm(grads)
    # the bias corrections divide as tensors on the gradients' device: a
    # CUDA division by a CPU scalar multiplies by its reciprocal instead
    device = next(iter(grads.values())).device
    bc1, bc2 = (b.to(device) for b in bias_corrections(state.step, b1, b2))
    new_m, new_v, u = {}, {}, {}
    for k, g in grads.items():
        g32 = g.float()
        new_m[k] = b1 * state.m[k] + (1 - b1) * g32
        new_v[k] = b2 * state.v[k] + (1 - b2) * torch.square(g32)
        u[k] = (new_m[k] / bc1) / (torch.sqrt(new_v[k] / bc2) + eps)
    if weight_decay != 0.0:
        u = {k: x + weak_scalar(weight_decay, params[k].dtype) * params[k]
             for k, x in u.items()}
    u = {k: trust_ratio(leaf_sumsq(params[k]), leaf_sumsq(x), trust_eps)
         * x.float() for k, x in u.items()}
    stats = {"grad_norm": gnorm, "lr": lr, "update_norm": global_norm(u)}
    new_p = {k: (w - lr * u[k]).to(w.dtype) for k, w in params.items()}
    return new_p, LambState(state.step + 1, new_m, new_v, state.form), stats


def _lamb_optimizer(schedule: Schedule, *, b1: float, b2: float, eps: float,
                    weight_decay: float = 0.0, trust_eps: float = 0.0,
                    clip: Optional[float] = None, fused: Optional[str] = None,
                    name: Optional[str] = None) -> Optimizer:
    """LAMB in the requested execution mode.  ``fused=None`` is the plain
    step; ``fused="multi_tensor"`` runs the engine's two passes on the
    resident ``FlatOptState`` (``m_flats``/``v_flats``) that ``init``
    returns, after a clip round where ``clip`` is given (3 launches).  A
    ``LambState`` fed to the fused optimizer takes the plain step, as a
    ``ChainOptState`` takes the interpreter step in JAX; a resident state
    fed to the plain path reads its buffer views."""
    if fused not in (None, "multi_tensor"):
        raise ValueError(f"fused={fused!r} is not available for lamb; "
                         f"use fused='multi_tensor' or None")
    kw = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
              trust_eps=trust_eps, clip=clip)
    form = ("lamb", 0 if clip is None else 1, 2)

    @torch.no_grad()
    def step_fn(grads, state, params):
        lr = schedule(state.step)
        if fused == "multi_tensor" and isinstance(state, FlatOptState):
            new_state, stats = resident_lamb_step(grads, state, lr=lr, **kw)
            return None, new_state, stats
        if isinstance(grads, FlatGrads):
            grads = grads.tree
        if isinstance(state, FlatOptState):
            if params is None:
                params = state.params
            state = LambState(state.step, *state.moments, state.form)
        if params is None:
            raise TypeError("lamb's plain step needs params; only a "
                            "FlatOptState owner supports params=None")
        return _plain_lamb_step(grads, state, params, lr, **kw)

    def init(params):
        if fused == "multi_tensor":
            return init_flat_adam_state(params, form=form)
        return LambState(0, _zeros_f32(params), _zeros_f32(params), form)

    return Optimizer(name or "lamb", init, step_fn, kind="lamb")


# ---------------------------------------------------------------------------
# segment plans: plain prefix stages + one fused engine tail + resident EMA
# slots, on the ("chain", slots) FlatOptState form
# ---------------------------------------------------------------------------

def _packing_cast(updates: Tree, layout) -> Optional[torch.dtype]:
    """Packing dtype for a plan tail's updates: None when every leaf still
    has its parameter's dtype, f32 when an earlier stage promoted every
    leaf (packing them at the bucket dtype would round them)."""
    if all(updates[s.path].dtype == s.dtype
           for b in layout.buckets for s in b.segments):
        return None
    if all(u.dtype == torch.float32 for u in updates.values()):
        return torch.float32
    raise ValueError(
        "segment plan tail got an update tree that neither matches the "
        "parameter dtypes leaf-for-leaf nor is uniformly f32; got dtypes "
        f"{sorted({str(u.dtype).rsplit('.', 1)[-1] for u in updates.values()})}")


def _plan_optimizer(tx: "T.GradientTransform", plan: "T.SegmentPlan", *,
                    name: Optional[str] = None) -> Optimizer:
    """``compile_chain``'s target for segment plans (plain prefix stages +
    one fused tail + EMA slots) under ``fused="multi_tensor"``.

    State is a ``FlatOptState`` with the ``("chain", slots)`` form: the
    tail's momentum resident in ``u_flats`` (lamb: ``m_flats``/
    ``v_flats``), one f32 shadow bucket set per ``ema_params`` stage in
    ``e_flats``.  Each step runs the plan's prefix stages leaf by leaf
    (as the interpreter does; zero launches), folds a clip just before
    the tail into the clip round, advances every EMA slot on the
    pre-step params (``ema_flats_update``, before the tail's kernels
    write ``p_flats`` in place; zero launches), and runs the tail on the
    engine (nesterov and trailing clip included).  Stats merge left to right as
    in the interpreter; a tail with no norm-emitting stage (msgd, lamb)
    takes its ``grad_norm`` from the prefix's report or the raw gradient
    norm.  A ``ChainOptState`` fed here steps on the interpreter."""
    fused_node = plan.fused
    kind = fused_node.kind
    kp = dict(fused_node.kwargs)
    schedule = kp["schedule"]
    prefix = tuple(n for n in plan.nodes if n.op == "jnp")
    emas = tuple(n for n in plan.nodes if n.op == "ema")
    form = ("chain", plan.slots)

    def init(params):
        if kind == "lamb":
            state = init_flat_adam_state(params, form=form)
        else:
            state = init_flat_state(params, form=form)
        if not emas:
            return state
        return dataclasses.replace(state, e_flats=tuple(
            init_ema_flats(params, state.layout) for _ in emas))

    def flat_step(grads, state):
        layout = state.layout
        lr = schedule(state.step)
        flat_in = isinstance(grads, FlatGrads)
        if flat_in:
            require_matching_layout(grads, layout)
        updates = grads.tree if (flat_in and prefix) else grads
        stats = {}
        if prefix:
            # the prefix reads the pre-step params: views of the buffers,
            # which the kernels overwrite only after these stages ran
            pview = state.params
            for node in prefix:
                updates, _, st = node.transform.update(updates, T.EmptyState(),
                                                       pview)
                stats.update(st)
        stat_gnorm = None
        if isinstance(updates, FlatGrads):
            # no prefix: the packed gradients feed the tail directly
            g_flats = list(updates.flats)
            if kp.get("clip") is not None:
                g_flats, stat_gnorm = _clip_flats_round(
                    g_flats, layout, float(kp["clip"]))
        else:
            cast = _packing_cast(updates, layout)
            if kp.get("clip") is not None:
                updates, stat_gnorm = _clip_tree_round(
                    updates, layout, float(kp["clip"]), cast_to=cast)
            g_flats = flatten(updates, layout, cast_to=cast)
        if stat_gnorm is None and kind in ("msgd", "lamb"):
            # no norm-emitting stage in the tail: the prefix's report, or
            # the interpreter's fallback, the raw gradient norm
            stat_gnorm = (stats["grad_norm"] if "grad_norm" in stats else
                          flat_global_norm(grads.flats, layout) if flat_in
                          else global_norm(grads))
        # the pre-step params: the tail's kernels overwrite p_flats in place
        for e, node in zip(state.e_flats, emas):
            ema_flats_update(e, state.p_flats, node.arg("decay"))
        if kind == "lamb":
            tstats = multi_tensor_lamb_step_flat(
                layout, state.p_flats, g_flats, state.m_flats, state.v_flats,
                count=state.step, lr=lr, b1=kp["b1"], b2=kp["b2"],
                eps=kp["eps"], weight_decay=kp["weight_decay"],
                trust_eps=kp["trust_eps"], stat_gnorm=stat_gnorm)
        else:
            tstats = multi_tensor_step_flat(
                kind, layout, state.p_flats, g_flats, state.u_flats, lr=lr,
                beta=kp["beta"], weight_decay=kp["weight_decay"],
                eps=kp["eps"], trust=kp["trust"],
                nesterov=kp.get("nesterov", False),
                suffix_clip=kp.get("suffix_clip"), stat_gnorm=stat_gnorm)
        stats.update(tstats)
        return dataclasses.replace(state, step=state.step + 1), stats

    @torch.no_grad()
    def step_fn(grads, state, params):
        if isinstance(state, FlatOptState):
            if state.form != form:
                raise TypeError(
                    f"segment-plan optimizer {name!r} got a FlatOptState "
                    f"with form {state.form!r}, expected {form!r}")
            new_state, stats = flat_step(grads, state)
            return None, new_state, stats
        if not isinstance(state, T.ChainOptState):
            raise TypeError(
                f"segment-plan optimizer expects a FlatOptState or "
                f"ChainOptState, got {type(state).__name__}")
        return T.interpreter_step(tx, grads, state, params)

    return Optimizer(name or f"chain[{kind}]", init, step_fn, kind=kind,
                     plan=plan)


# ---------------------------------------------------------------------------
# the optimizers: chains, compiled
# ---------------------------------------------------------------------------

def sngm(schedule: Schedule, beta: float = 0.9, weight_decay: float = 0.0,
         eps: float = 1e-12, norm_mode: str = "global", nesterov: bool = False,
         ema_decay: Optional[float] = None,
         fused: Optional[str] = None) -> Optimizer:
    """Stochastic Normalized Gradient descent with Momentum (Algorithm 1).

        u_{t+1} = beta * u_t + g_t / ||g_t||
        w_{t+1} = w_t - eta_t * u_{t+1}

    ``norm_mode``: "global" (the paper: one norm over the whole gradient)
    or "per_tensor" (each tensor normalized by its own norm).  ``nesterov``
    applies look-ahead momentum; the engine fuses it into the update
    pass, so the launch count is unchanged.  ``ema_decay`` keeps an
    exponential moving average of the params (an ``ema_params`` stage);
    with ``fused="multi_tensor"`` the shadow params are resident f32
    slots (``FlatOptState.e_flats``)."""
    if norm_mode not in ("global", "per_tensor"):
        raise ValueError(norm_mode)
    fused = _resolve_fused(fused)
    if fused == "per_leaf" and norm_mode != "global":
        raise ValueError("fused='per_leaf' supports norm_mode='global' only; "
                         "use fused='multi_tensor' for per_tensor")
    normalize = (T.normalize_by_global_norm if norm_mode == "global"
                 else T.normalize_per_tensor)
    stages = [T.add_decayed_weights(weight_decay), normalize(eps),
              T.trace(beta, nesterov=nesterov), T.scale_by_schedule(schedule)]
    if ema_decay is not None:
        stages.append(T.ema_params(ema_decay))
    tx = T.chain(*stages)
    return T.compile_chain(tx, fused=fused, name=f"sngm[{norm_mode}]")


def sngd(schedule: Schedule, weight_decay: float = 0.0, eps: float = 1e-12,
         norm_mode: str = "global", fused: Optional[str] = None) -> Optimizer:
    """Stochastic normalized gradient descent = SNGM with beta = 0."""
    opt = sngm(schedule, beta=0.0, weight_decay=weight_decay, eps=eps,
               norm_mode=norm_mode, fused=fused)
    return dataclasses.replace(opt, name="sngd")


def msgd(schedule: Schedule, beta: float = 0.9, weight_decay: float = 0.0,
         nesterov: bool = False, fused: Optional[str] = None) -> Optimizer:
    """Momentum SGD:  v_{t+1} = beta v_t + g_t ;  w_{t+1} = w_t - eta v_{t+1}.
    No per-leaf kernel exists for it."""
    fused = _resolve_fused(fused, allowed=("multi_tensor",))
    tx = T.chain(T.add_decayed_weights(weight_decay),
                 T.trace(beta, nesterov=nesterov),
                 T.scale_by_schedule(schedule))
    return T.compile_chain(tx, fused=fused, name="msgd")


def lars(schedule: Schedule, beta: float = 0.9, weight_decay: float = 0.0,
         trust: float = 0.001, eps: float = 1e-12,
         fused: Optional[str] = None) -> Optimizer:
    """Layer-wise Adaptive Rate Scaling (pytorch-lars, as the paper used):

        local_lr = trust * ||w|| / (||g|| + wd * ||w|| + eps)   per tensor
        v = beta v + eta * local_lr * (g + wd * w)
        w = w - v

    The schedule scales what enters the momentum, so ``scale_by_schedule``
    precedes ``trace`` in the chain."""
    fused = _resolve_fused(fused)
    tx = T.chain(T.trust_ratio(trust, weight_decay, eps),
                 T.scale_by_schedule(schedule), T.trace(beta))
    return T.compile_chain(tx, fused=fused, name="lars")


def lamb(schedule: Schedule, b1: float = 0.9, b2: float = 0.999,
         weight_decay: float = 0.0, eps: float = 1e-6,
         fused: Optional[str] = None) -> Optimizer:
    """LAMB (You et al. 2020), the large-batch baseline beside LARS:
    bias-corrected Adam direction, decoupled weight decay, per-tensor
    trust-ratio rescale, schedule last.  Stats: the raw gradient norm,
    the lr, and the trust-scaled direction's norm before the lr."""
    tx = T.chain(T.scale_by_adam(b1, b2, eps),
                 T.add_decayed_weights(weight_decay),
                 T.scale_by_trust_ratio(), T.scale_by_schedule(schedule))
    return T.compile_chain(tx, fused=fused, name="lamb")


OPTIMIZERS = {"sngm": sngm, "sngd": sngd, "msgd": msgd, "lars": lars,
              "lamb": lamb}


def optimizer_names() -> Tuple[str, ...]:
    return tuple(sorted(OPTIMIZERS))


def builder_accepts(name: str, key: str) -> bool:
    """Whether the registered builder takes ``key`` as a keyword: how the
    launcher maps its fixed flag set onto each optimizer."""
    return key in inspect.signature(OPTIMIZERS[name]).parameters


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """The JSON-safe identity of an optimizer, as in the JAX package:
    registry ``name`` plus the builder kwargs, the schedule a declarative
    ``{"name", "kwargs"}`` spec under ``kwargs["schedule"]``.  Persisted
    in ``train_meta.json`` so ``--resume`` rebuilds the optimizer of the
    original run, whichever package wrote it."""
    name: str
    kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.name not in OPTIMIZERS:
            raise KeyError(f"unknown optimizer {self.name!r}; "
                           f"available {optimizer_names()}")
        if "schedule" not in self.kwargs:
            raise ValueError("OptimizerSpec.kwargs must carry a 'schedule' "
                             "spec ({'name': ..., 'kwargs': {...}})")

    def to_json(self) -> dict:
        out = {"name": self.name, "kwargs": dict(self.kwargs)}
        json.dumps(out)   # fail fast on non-serializable kwargs
        return out

    @classmethod
    def from_json(cls, d: Mapping[str, Any]) -> "OptimizerSpec":
        return cls(name=d["name"], kwargs=dict(d["kwargs"]))

    def build(self) -> Optimizer:
        kwargs = dict(self.kwargs)
        schedule = make_schedule(kwargs.pop("schedule"))
        return OPTIMIZERS[self.name](schedule, **kwargs)


def make_optimizer(name, schedule=None, **kw) -> Optimizer:
    """Two forms, as in the JAX package:
    ``make_optimizer("sngm", schedule, beta=0.9, ...)``, ``schedule`` a
    callable or a ``{"name", "kwargs"}`` spec; or ``make_optimizer(spec)``
    from an ``OptimizerSpec`` (no further arguments)."""
    if isinstance(name, OptimizerSpec):
        if schedule is not None or kw:
            raise TypeError("make_optimizer(spec) takes no extra arguments; "
                            "the spec already carries schedule and kwargs")
        return name.build()
    if name not in OPTIMIZERS:
        raise KeyError(f"unknown optimizer {name!r}; available "
                       f"{optimizer_names()}")
    if schedule is None:
        raise TypeError("make_optimizer(name, schedule, ...) requires a schedule")
    if isinstance(schedule, dict):
        schedule = make_schedule(schedule)
    return OPTIMIZERS[name](schedule, **kw)
