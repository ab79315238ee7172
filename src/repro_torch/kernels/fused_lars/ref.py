"""Plain PyTorch versions of the per-leaf LARS passes.

``lars_sqnorm_ref`` gives one tensor's CHUNK-row sums of squares in the
port's canonical order (``core.multi_tensor.leaf_sumsq`` folds exactly
these rows), where the JAX kernel (``repro.kernels.fused_lars.kernel.
_sqnorm``) leaves a block's order to XLA.  ``lars_update_ref`` mirrors
``_upd_kernel`` expression for expression, with ``wd*w`` rounded to w's
dtype as JAX's weakly typed float is, and the new ``w`` cast back to its
dtype as ``repro/core/optim.py:503`` does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.multi_tensor.ref import CHUNK, row_sum, weak_scalar


def lars_sqnorm_ref(x: torch.Tensor) -> torch.Tensor:
    """(max(1, ceil(n / CHUNK)),) f32 row sums of x^2; a ragged last row
    counts as zero-padded, an empty tensor as one zero row."""
    xf = x.float().reshape(-1)
    pad = -xf.numel() % CHUNK
    if pad or xf.numel() == 0:
        xf = torch.cat([xf, xf.new_zeros(pad or CHUNK)])
    x2 = xf.view(-1, CHUNK)
    return row_sum(x2 * x2)


def lars_update_ref(w: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
                    lr_local: torch.Tensor, *, beta: float, wd: float):
    """``v_new = beta*v + lr_local*(g + wd*w)``, ``w_new = (w - v_new)``
    in w's dtype; returns (w_new, v_new [f32]) as new tensors."""
    v_new = beta * v + lr_local * (g.float() + weak_scalar(wd, w.dtype) * w)
    return (w - v_new).to(w.dtype), v_new
