"""Train-step builder: gradient accumulation over micro-batches plus any
``repro_torch.core`` optimizer.  A port of ``repro.training.step``.

The optimizer sees the accumulated global-batch gradient, so SNGM
normalizes once per global batch, exactly Algorithm 1.  Two ways to
accumulate, as in the JAX package:

  * resident state (``fused="multi_tensor"``): every parameter leaf is a
    view into the state's flat ``p_flats`` and its ``.grad`` a view into
    one flat gradient buffer per bucket, so autograd adds each
    micro-batch's gradient straight into the engine's ``FlatGrads`` and
    nothing is packed per step;
  * otherwise: autograd accumulates each leaf's ``.grad`` in the
    parameter dtype (the JAX package's tree accumulator).

Either way the sum is divided by ``n_micro`` at the end.  The first
micro-batch adds into zeros on the resident path (0 + g), where the
JAX package's non-accumulating n_micro=1 path keeps g itself; the two
differ only in the sign of a zero gradient, which no optimizer output
can show (a -0.0 and a +0.0 gradient give the same momentum and
parameters from a +0.0-initialised momentum).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.multi_tensor import FlatGrads, FlatOptState, zeros_flats
from repro_torch.core.optim import Optimizer, TrainState
from repro_torch.core.transform import as_optimizer
from repro_torch.models.runtime import Runtime
from repro_torch.models.transformer import forward, unembed_matrix
from repro_torch.training.loss import lm_loss


def gather_cast(params, rt: Runtime):
    """``params`` with every fp32 leaf of two or more dims, as stored
    (a stacked norm scale is one), cast to ``rt.gather_dtype``: the JAX
    package's rule (its comment names matrices; its test is the ndim).
    The cast is differentiable, so gradients reach the fp32 leaves."""
    if rt.gather_dtype == "float32":
        return params
    gd = getattr(torch, rt.gather_dtype)
    return {k: v.to(gd) if v.dim() >= 2 and v.dtype == torch.float32 else v
            for k, v in params.items()}


def loss_fn(params, batch: Dict[str, Any], cfg: ModelConfig, rt: Runtime):
    """``batch``: tokens, loss_mask and, for an encoder-decoder,
    encoder_embeds (B, encoder_len, d)."""
    params = gather_cast(params, rt)
    h, aux = forward(params, cfg, rt, batch["tokens"], mode="train",
                     encoder_embeds=batch.get("encoder_embeds"))
    loss, ntok = lm_loss(h, unembed_matrix(params), batch["tokens"],
                         batch["loss_mask"], cfg)
    return loss + aux, {"ce_loss": loss, "aux_loss": aux, "ntok": ntok}


# How loss_fn's aux metrics combine across micro-batches (as in the JAX
# package): COUNT_METRICS sum to the global total, TOKEN_WEIGHTED_METRICS
# are per-token means weighted by ntok, everything else is a plain mean.
COUNT_METRICS = ("ntok",)
TOKEN_WEIGHTED_METRICS = ("ce_loss",)


def _grad_leaves(state: TrainState):
    """The parameter dict the loss differentiates, with ``.grad`` ready to
    accumulate into, and the gradient buffers (FlatGrads on the resident
    path, None otherwise)."""
    opt_state = state.opt_state
    if state.params is None and isinstance(opt_state, FlatOptState):
        layout = opt_state.layout
        g_flats = zeros_flats(layout, device=opt_state.p_flats[0].device)
        params = opt_state.params
        grads = FlatGrads(tuple(g_flats), layout)
        for path, g in grads.tree.items():
            params[path].requires_grad_(True)
            params[path].grad = g
        return params, grads
    params = {k: v.detach().requires_grad_(True)
              for k, v in state.params_view.items()}
    return params, None


@torch.no_grad()
def _mean_grads(params, flat: Optional[FlatGrads], n_micro: int):
    """The accumulated gradients of ``_grad_leaves`` divided by
    ``n_micro``: the flat buffers in place, or a new dict."""
    if flat is not None:
        for f in flat.flats:
            f.div_(n_micro)
        return flat
    return {k: v.grad / n_micro if n_micro > 1 else v.grad
            for k, v in params.items()}


def make_train_step(cfg: ModelConfig, rt: Runtime, opt: Optimizer,
                    n_micro: int = 1):
    """Returns train_step(state, batch) -> (state', stats) over the unified
    ``TrainState`` (build one with ``opt.init_state(params)``).  ``opt``
    may also be a gradient-transform chain, compiled on the spot
    (``core.transform.as_optimizer``).

    batch["tokens"]: (B, S) global batch, accumulated over ``n_micro``
    micro-batches of B / n_micro rows; every other leaf of the batch
    (loss_mask, an encoder-decoder's encoder_embeds) is split alike.
    Stats stay 0-dim tensors on the
    device (no host sync inside the step)."""
    opt = as_optimizer(opt)

    def train_step(state: TrainState, batch):
        B = batch["tokens"].shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} does not split into {n_micro} "
                             f"micro-batches")
        params, flat = _grad_leaves(state)
        mb = B // n_micro
        losses, m_stack = [], []
        for i in range(n_micro):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, metrics = loss_fn(params, micro, cfg, rt)
            loss.backward()
            losses.append(loss.detach())
            m_stack.append({k: v.detach() for k, v in metrics.items()})

        with torch.no_grad():
            grads = _mean_grads(params, flat, n_micro)
            if n_micro == 1:
                loss, metrics = losses[0], m_stack[0]
            else:
                l_sum = torch.zeros((), dtype=torch.float32, device=losses[0].device)
                for l in losses:
                    l_sum = l_sum + l
                loss = l_sum / n_micro
                metrics = {k: _combine(k, [m[k] for m in m_stack], m_stack)
                           for k in m_stack[0]}
        del params
        new_state, stats = opt.step_state(grads, state)
        stats = dict(stats)
        stats["loss"] = loss
        stats.update({k: v for k, v in metrics.items() if v.dim() == 0})
        return new_state, stats

    return train_step


def _combine(k, vals, m_stack):
    v = torch.stack(vals)
    if k in COUNT_METRICS:
        return v.sum(0)
    if k in TOKEN_WEIGHTED_METRICS and "ntok" in m_stack[0]:
        w = torch.stack([m["ntok"] for m in m_stack]).float()
        w = w.reshape(w.shape[:1] + (1,) * (v.dim() - 1))
        return (v * w).sum(0) / w.sum()
    return v.mean(0)


def run_steps(step_fn, state: TrainState, batches, n_steps: int, *,
              start: int = 0, tracker=None, callbacks=(), log_every: int = 1,
              summary: Optional[Dict[str, Any]] = None,
              step_hook=None) -> TrainState:
    """Host-side training loop around ``train_step(state, batch) ->
    (state', stats)``: threads the state, buffers the per-step device
    stats and drains them into the tracker every ``log_every`` steps.
    ``batches`` is a ``batch_at(t)`` callable or an iterable of batches
    (an exhausted iterator ends the run early).  ``step_hook(t, state)``
    runs after every step with the new state."""
    from repro_torch.tracker.callbacks import CallbackRunner
    runner = CallbackRunner(tracker, callbacks, flush_every=log_every)
    if callable(batches) and not hasattr(batches, "__next__"):
        next_batch = batches
    else:
        it = iter(batches)
        next_batch = lambda t: next(it)           # noqa: E731
    for t in range(start, n_steps):
        try:
            batch = next_batch(t)
        except StopIteration:
            break
        state, stats = step_fn(state, batch)
        runner.push(t, stats)
        if step_hook is not None:
            step_hook(t, state)
    runner.close(summary)
    return state
