"""Weights and optimizer state across: the JAX package's params pytree
<-> the port's ``{dotted.path: Tensor}`` dict, bitwise.  Optimizer
states: the momentum kinds' (``OptState`` / resident), LAMB's, an
interpreter-run chain's ``ChainOptState`` and a segment-plan optimizer's
``("chain", slots)`` resident state, EMA shadow slots included.

The JAX side hands over its tree as numpy arrays (``np.asarray`` of
each leaf, nested dicts keyed as in ``repro.models.transformer.
model_defs``).  ``from_numpy_tree`` flattens it to dotted paths
("blocks.L0.attn.wq") and ``to_numpy_tree`` rebuilds the nested dict.
Stacked period dims stay leading.  bfloat16 arrays cross as their
16-bit patterns: numpy has no bfloat16 of its own, so the numpy side
uses ``ml_dtypes.bfloat16`` (the type JAX hands out), imported only
when a bfloat16 leaf is met.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch


def _is_bf16(dtype: np.dtype) -> bool:
    return dtype.name == "bfloat16"


def array_to_tensor(a: np.ndarray) -> torch.Tensor:
    # not np.ascontiguousarray: it turns a 0-d array into shape (1,)
    a = np.asarray(a)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = a.copy(order="C")          # e.g. np.asarray of a JAX array
    if _is_bf16(a.dtype):
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def from_numpy_tree(tree: Dict[str, Any],
                    prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays -> ``{dotted.path: Tensor}`` on the
    CPU (move them with ``.to(device)``)."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if "." in k:
            raise ValueError(f"key {k!r} contains the path separator '.'")
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(from_numpy_tree(v, path + "."))
        else:
            out[path] = array_to_tensor(np.asarray(v))
    return out


def to_numpy_tree(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """``{dotted.path: Tensor}`` -> nested dict of numpy arrays."""
    tree: Dict[str, Any] = {}
    for path, t in flat.items():
        *parents, leaf = path.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = tensor_to_array(t)
    return tree


def _trees_on(device, params: Dict[str, Any], *slots: Dict[str, Any]):
    """numpy trees -> dotted dicts on ``device``; every slot keyed like
    the params."""
    p = {k: v.to(device) for k, v in from_numpy_tree(params).items()}
    out = [p]
    for slot in slots:
        t = {k: v.to(device) for k, v in from_numpy_tree(slot).items()}
        if set(t) != set(p):
            raise ValueError("optimizer slot keys do not match the params'")
        out.append(t)
    return out


def train_state_from_numpy(params: Dict[str, Any], momentum: Dict[str, Any],
                           step: int = 0, *, resident: bool,
                           device="cpu"):
    """The JAX package's params and ``OptState.momentum`` (numpy trees)
    -> the port's ``TrainState``: resident (params and momentum packed
    into flat buffers, as ``fused="multi_tensor"`` keeps them) or in
    dict form (``OptState``), on ``device``.  Bitwise, bf16 included."""
    from repro_torch.core.multi_tensor import build_layout, flatten
    from repro_torch.core.optim import FlatOptState, OptState, TrainState
    p, u = _trees_on(device, params, momentum)
    if not resident:
        return TrainState(params=p, opt_state=OptState(int(step), u))
    layout = build_layout(p)
    return TrainState(params=None, opt_state=FlatOptState(
        step=int(step), p_flats=tuple(flatten(p, layout)),
        u_flats=tuple(flatten(u, layout, cast_to=torch.float32)),
        layout=layout))


def train_state_to_numpy(state):
    """Inverse of ``train_state_from_numpy``, for either form: (params,
    momentum, step) as numpy trees keyed like the JAX package's."""
    return (to_numpy_tree(state.params_view),
            to_numpy_tree(state.opt_state.momentum), int(state.step))


def lamb_state_from_numpy(params: Dict[str, Any], m: Dict[str, Any],
                          v: Dict[str, Any], step: int = 0, *,
                          resident: bool, device="cpu"):
    """LAMB's state across: the JAX package's params and both Adam
    moments (numpy trees: ``ChainOptState.inner[0].m``/``.v`` of the
    interpreter form, or ``FlatOptState.moments`` of the engine form)
    -> the port's ``TrainState``, resident (``FlatOptState`` with
    ``m_flats``/``v_flats``, as ``lamb(fused="multi_tensor")`` keeps it)
    or in dict form (``LambState``), on ``device``.  Bitwise."""
    from repro_torch.core.multi_tensor import (LAMB_FORM, build_layout,
                                               flatten)
    from repro_torch.core.optim import FlatOptState, LambState, TrainState
    p, mt, vt = _trees_on(device, params, m, v)
    if not resident:
        return TrainState(params=p, opt_state=LambState(int(step), mt, vt))
    layout = build_layout(p)
    return TrainState(params=None, opt_state=FlatOptState(
        step=int(step), p_flats=tuple(flatten(p, layout)), u_flats=(),
        layout=layout,
        m_flats=tuple(flatten(mt, layout, cast_to=torch.float32)),
        v_flats=tuple(flatten(vt, layout, cast_to=torch.float32)),
        form=LAMB_FORM))


def lamb_state_to_numpy(state):
    """Inverse of ``lamb_state_from_numpy``, for either form: (params, m,
    v, step) as numpy trees keyed like the JAX package's."""
    opt = state.opt_state
    m, v = opt.moments if hasattr(opt, "moments") else (opt.m, opt.v)
    return (to_numpy_tree(state.params_view), to_numpy_tree(m),
            to_numpy_tree(v), int(state.step))


def chain_state_from_numpy(params: Dict[str, Any], state, *, device="cpu"):
    """The JAX interpreter's state across: params and a ``ChainOptState``
    whose leaves are numpy arrays (``jax.tree.map(np.asarray, state)``)
    -> the port's ``TrainState`` (params, ``ChainOptState``) on
    ``device``.  Each stage's state is recognised by its fields: ()
    stateless, (momentum,) ``trace``, (count,) ``scale_by_schedule``,
    (count, m, v) ``scale_by_adam``, (ema,) ``ema_params``.  Counters
    become ints; bitwise, bf16 params included (the shadows are f32)."""
    from repro_torch.core import transform as T
    from repro_torch.core.optim import TrainState
    (p,) = _trees_on(device, params)

    def slot(tree):
        return _trees_on(device, params, tree)[1]

    inner = []
    for s in state.inner:
        f = s._asdict()
        keys = tuple(sorted(f))
        if keys == ():
            inner.append(T.EmptyState())
        elif keys == ("momentum",):
            inner.append(T.TraceState(slot(f["momentum"])))
        elif keys == ("count",):
            inner.append(T.ScaleByScheduleState(int(f["count"])))
        elif keys == ("count", "m", "v"):
            inner.append(T.ScaleByAdamState(int(f["count"]), slot(f["m"]),
                                            slot(f["v"])))
        elif keys == ("ema",):
            inner.append(T.EmaParamsState(slot(f["ema"])))
        else:
            raise TypeError(f"no port state for a chain stage with fields {keys}")
    return TrainState(params=p,
                      opt_state=T.ChainOptState(int(state.step), tuple(inner)))


def plan_state_from_numpy(params: Dict[str, Any], slots, step: int, *,
                          momentum: Optional[Dict[str, Any]] = None,
                          m: Optional[Dict[str, Any]] = None,
                          v: Optional[Dict[str, Any]] = None,
                          emas: Sequence[Dict[str, Any]] = (), device="cpu"):
    """A segment-plan optimizer's resident state across: the JAX
    package's ``FlatOptState`` of form ``("chain", slots)``, given as its
    numpy views (``state.params`` and ``state.momentum``, or
    ``state.moments`` for an ``"adam"`` slot, and ``state.ema_views``,
    one per ``"ema"`` slot) -> the port's ``TrainState`` (params None,
    ``FlatOptState`` of the same form) on ``device``.  Bitwise."""
    from repro_torch.core.multi_tensor import build_layout, flatten
    from repro_torch.core.optim import FlatOptState, TrainState
    slots = tuple(slots)
    want_u, want_mv = "trace" in slots, "adam" in slots
    if (want_u != (momentum is not None)
            or want_mv != (m is not None and v is not None)
            or slots.count("ema") != len(emas)):
        raise ValueError(f"slots {slots} need momentum for 'trace', m, v "
                         f"for 'adam' and one shadow tree per 'ema', and "
                         f"nothing else")
    trees = _trees_on(device, params, *([momentum] if want_u else []),
                      *([m, v] if want_mv else []), *emas)
    p = trees[0]
    layout = build_layout(p)

    def packed(t):
        return tuple(flatten(t, layout, cast_to=torch.float32))
    return TrainState(params=None, opt_state=FlatOptState(
        step=int(step), p_flats=tuple(flatten(p, layout)),
        u_flats=packed(trees[1]) if want_u else (), layout=layout,
        m_flats=packed(trees[1]) if want_mv else (),
        v_flats=packed(trees[2]) if want_mv else (),
        e_flats=tuple(packed(t) for t in trees[len(trees) - len(emas):]),
        form=("chain", slots)))
