"""Weights across: the JAX package's params pytree <-> the port's
``{dotted.path: Tensor}`` dict, bitwise.

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

from typing import Any, Dict

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


def train_state_from_numpy(params: Dict[str, Any], momentum: Dict[str, Any],
                           step: int = 0, *, resident: bool,
                           device="cpu"):
    """The JAX package's params and ``OptState.momentum`` (numpy trees)
    -> the port's ``TrainState``: resident (params and momentum packed
    into flat buffers, as ``fused="multi_tensor"`` keeps them) or in
    dict form (``OptState``), on ``device``.  Bitwise, bf16 included."""
    from repro_torch.core.multi_tensor import build_layout, flatten
    from repro_torch.core.optim import FlatOptState, OptState, TrainState
    p = {k: v.to(device) for k, v in from_numpy_tree(params).items()}
    u = {k: v.to(device) for k, v in from_numpy_tree(momentum).items()}
    if set(u) != set(p):
        raise ValueError("momentum keys do not match the params'")
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
