"""Parameter abstraction: models declare abstract trees of ``ParamDef``
(shape + logical axis names + init), as in ``repro.models.param``.

The port's parameters are a flat ``{dotted.path: Tensor}`` dict
("blocks.L0.attn.wq"); stacked period dims stay leading, as in the JAX
tree.  ``materialize`` draws each leaf from the JAX package's key for
it (``repro_torch.prng``), so a normal leaf is the JAX ``materialize``'s
to ``prng.NORMAL_ULP`` ulp and every other leaf is bitwise its.
"""
from __future__ import annotations

import math
import zlib
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import prng


class ParamDef(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis name per dim
    init: str = "normal"   # normal | zeros | ones | embed | const | arange_log
    scale: float = -1.0               # -1 -> 1/sqrt(fan_in) for "normal"
    dtype: torch.dtype = torch.float32


def flatten_defs(tree, prefix: str = "") -> Dict[str, Any]:
    """Nested dict of leaves -> ``{dotted.path: leaf}`` in insertion order."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_defs(v, path + "."))
        else:
            out[path] = v
    return out


def map_defs(f, tree):
    return {k: map_defs(f, v) if isinstance(v, dict) else f(v)
            for k, v in tree.items()}


def stack(tree, n: int, axis_name: str = "layers"):
    """Add a leading stacked-layer dim of size n to every ParamDef."""
    return map_defs(lambda d: d._replace(shape=(n,) + d.shape,
                                         axes=(axis_name,) + d.axes), tree)


def _fan_in(d: ParamDef) -> float:
    """Fan-in from the logical-axis layout (as ``repro.models.param``):
    2D mats are (in, out); 3D projections back to the residual stream
    (last axis "embed") contract everything before it; other 3D
    projections contract their first dim."""
    if len(d.shape) < 2:
        return float(d.shape[-1])
    if len(d.shape) == 2:
        return float(d.shape[0])
    if d.axes and d.axes[-1] == "embed":
        return float(math.prod(d.shape[:-1]))
    return float(d.shape[0])


def _path_hash(path: str) -> int:
    """The JAX package's per-leaf fold-in (``repro.models.param._path_hash``):
    crc32 of the leaf's JAX key path, ``['blocks']/['L0']/['attn']/['wq']``
    for the dotted path ``blocks.L0.attn.wq``."""
    jax_path = "/".join(f"[{k!r}]" for k in path.split("."))
    return zlib.crc32(jax_path.encode()) & 0x7FFFFFFF


def materialize(tree, key: torch.Tensor, device: torch.device,
                cast=None) -> Dict[str, torch.Tensor]:
    """Initialize every leaf on ``device`` from ``fold_in(key,
    _path_hash(path))``, as the JAX ``materialize`` does from the same
    key.  The fan-in is read from the leaf's stacked shape, exactly as
    the JAX ``materialize`` reads it.  ``cast(path, tensor)``, if given,
    is applied to each leaf as soon as it is drawn (the serving launcher
    casts matmul weights to the compute dtype there), so the peak is the
    tree so far plus one leaf as drawn."""
    out = {}
    for path, d in flatten_defs(tree).items():
        if d.init == "zeros":
            t = torch.zeros(d.shape, dtype=d.dtype, device=device)
        elif d.init == "ones":
            t = torch.ones(d.shape, dtype=d.dtype, device=device)
        elif d.init == "const":
            t = torch.full(d.shape, d.scale, dtype=d.dtype, device=device)
        elif d.init == "arange_log":      # Mamba A_log: log(uniform[1, 16])
            leaf_key = prng.fold_in(key, _path_hash(path))
            t = torch.log(prng.uniform(leaf_key, d.shape, 1.0, 16.0,
                                       device)).to(d.dtype)
        else:
            scale = d.scale if d.scale >= 0 else 1.0 / math.sqrt(_fan_in(d))
            leaf_key = prng.fold_in(key, _path_hash(path))
            t = prng.normal(leaf_key, d.shape, device).mul_(scale).to(d.dtype)
        out[path] = t if cast is None else cast(path, t)
        del t
    return out


def count(tree) -> int:
    return sum(math.prod(d.shape) for d in flatten_defs(tree).values())

