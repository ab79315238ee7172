"""Engine counters: the launch, packing and residency numbers every
benchmark record is stamped with.  A port of ``repro.tracker.counters``.

The JAX package takes its counts when a step is traced
(``jax.jit(...).lower``), without running it.  Eager PyTorch has no
trace, so these counters run one step, on clones of the gradients, the
optimizer state and the parameters: the caller's state keeps its bits
(a resident step would otherwise update its flat buffers in place).
The counts do not depend on the values or on the device: every kernel
wrapper adds one to ``repro_torch.kernels.CALLS`` on entry, on the CPU
as on the card, where the same step launches each call's kernel once.

  * ``launches_per_step``     — kernel launches in one optimizer step
                                (the engine's O(1) against the per-leaf
                                path's O(n_leaves));
  * ``packed_bytes_per_step`` — bytes packed into the engine's flat
                                buffers in one step (a resident
                                ``FlatOptState`` packs gradients only);
  * ``param_bytes_live``      — parameter bytes a ``TrainState`` holds
                                across steps (1x on the resident path);
  * ``plan_launches_per_step``— the segment compiler's own launch count
                                (``SegmentPlan.launches_per_bucket`` x
                                buckets), held against the counted one;
  * ``engine_counters``       — the first three for an (optimizer,
                                params) pair.

The JAX package's ``capture_donation_warnings`` has no counterpart:
eager PyTorch donates no buffers, and the resident step updates its
buffers in place, which ``param_bytes_live`` checks (1x).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.core.multi_tensor import (FlatOptState, build_layout,
                                           count_packed_bytes)
from repro_torch.core.optim import Optimizer, TrainState
from repro_torch.kernels import count_kernel_calls

__all__ = ["launches_per_step", "packed_bytes_per_step", "param_bytes_live",
           "engine_counters", "plan_launches_per_step"]


def _cloned(x):
    """``x`` with every tensor inside cloned (dicts, tuples, NamedTuples
    and dataclasses rebuilt around them); anything holding no tensor is
    returned as it is."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        new = {k: _cloned(v) for k, v in x.items()}
        return x if all(new[k] is x[k] for k in x) else new
    if isinstance(x, (tuple, list)):
        new = [_cloned(v) for v in x]
        if all(a is b for a, b in zip(new, x)):
            return x
        return type(x)(*new) if hasattr(x, "_fields") else type(x)(new)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        fields = [f.name for f in dataclasses.fields(x) if f.init]
        new = {k: _cloned(getattr(x, k)) for k in fields}
        if all(new[k] is getattr(x, k) for k in fields):
            return x
        return dataclasses.replace(x, **new)
    return x


def _step_counts(opt: Optimizer, grads, state, params) -> Tuple[int, int]:
    """(kernel launches, packed bytes) of one ``opt.step`` on clones."""
    grads, state, params = _cloned((grads, state, params))
    with count_kernel_calls() as calls, count_packed_bytes() as packed:
        opt.step(grads, state, params)
    return calls["launches"], int(packed["bytes"])


def launches_per_step(opt: Optimizer, grads, state, params) -> int:
    """Kernel launches one optimizer step makes."""
    return _step_counts(opt, grads, state, params)[0]


def packed_bytes_per_step(opt: Optimizer, grads, state, params) -> int:
    """Bytes packed into flat buffers in one step.  A resident state
    (``FlatOptState``) fed a gradient dict packs only the gradients (fed
    the ``FlatGrads`` the train step accumulates, nothing); an
    ``OptState`` on the engine re-packs params, grads and momentum."""
    return _step_counts(opt, grads, state, params)[1]


def param_bytes_live(ts: TrainState) -> int:
    """Parameter bytes the TrainState keeps across steps: the params dict
    (when it owns them) plus the resident flat buffers (when a
    ``FlatOptState`` does)."""
    n = 0
    if ts.params is not None:
        n += sum(v.numel() * v.element_size() for v in ts.params.values())
    if isinstance(ts.opt_state, FlatOptState):
        n += sum(f.numel() * f.element_size() for f in ts.opt_state.p_flats)
    return n


def plan_launches_per_step(opt: Optimizer, params) -> Any:
    """The launch count the optimizer's ``SegmentPlan`` predicts: launches
    per bucket times the dtype buckets of ``params``.  None without a
    fused plan (the interpreter, the per-leaf path, no fusible tail):
    then the counted ``launches_per_step`` is the only count."""
    plan = getattr(opt, "plan", None)
    if plan is None or plan.kind is None or opt.kind is None:
        return None
    return plan.launches_per_bucket() * len(build_layout(params).buckets)


def engine_counters(opt: Optimizer, params) -> Dict[str, Any]:
    """The counter bundle for an (optimizer, params) pair, from one step
    on gradients of ones (the counts do not depend on the values)."""
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    state = opt.init(params)
    launches, packed = _step_counts(opt, grads, state, params)
    return {"launches_per_step": launches, "packed_bytes_per_step": packed,
            "param_bytes_live": param_bytes_live(TrainState.wrap(params, state))}
