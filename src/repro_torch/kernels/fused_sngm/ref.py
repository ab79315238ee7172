"""Plain PyTorch version of the per-leaf SNGM update.

Mirrors ``repro.kernels.fused_sngm.ref.sngm_update_ref`` expression for
expression, with one choice of the port: the new parameters come back in
the leaf's own dtype, where the JAX kernel returns fp32 for a bf16 leaf
(``repro/kernels/fused_sngm/kernel.py:60-61``); the port's value is the
JAX one rounded to bf16.
"""
from __future__ import annotations

import torch


def sngm_update_ref(p: torch.Tensor, g: torch.Tensor, u: torch.Tensor,
                    inv_norm: torch.Tensor, lr: torch.Tensor, *,
                    beta: float):
    """``u_new = beta*u + g*inv_norm``, ``p_new = (p - lr*u_new).to(p.dtype)``;
    returns (p_new, u_new [f32]) as new tensors."""
    u_new = beta * u + g.float() * inv_norm
    p_new = (p - lr * u_new).to(p.dtype)
    return p_new, u_new
