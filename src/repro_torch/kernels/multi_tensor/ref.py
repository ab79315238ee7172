"""Plain PyTorch versions of the multi-tensor optimizer passes.

Mirror ``repro.kernels.multi_tensor.ref`` (``chunk_sumsq_ref``,
``fused_update_ref``, ``scale_apply_ref``, ``adam_update_ref``) and
``kernel.py:_decay`` expression for expression on the same
(n / CHUNK, CHUNK) row view.  Two choices of the port:

  * the sum over a row is an explicit pairwise halving of its CHUNK
    squares (``row_sum``), where the JAX package leaves the order to
    XLA's ``jnp.sum``.  The CUDA kernel follows the same tree, so kernel
    and plain version agree bitwise; against the JAX package the sums
    agree to a few ulp;
  * a scalar that meets a tensor of another type is rounded to that type
    first (``weak_scalar``), as JAX's weakly typed Python floats are: for
    bf16 ``wd * p`` multiplies bf16(wd) by p and rounds to bf16.

The wrapper in ``ops.py`` runs these for CPU tensors; the tests and
``chip_smoke.py`` hold the CUDA kernels against them.
"""
from __future__ import annotations

import torch

CHUNK = 1024        # elements per row == per-coefficient granularity
TILE_ROWS = 64      # rows per TPU grid step; buffers stay TILE multiples
TILE = TILE_ROWS * CHUNK


def weak_scalar(value: float, dtype: torch.dtype) -> torch.Tensor:
    """A Python float as JAX uses it against an array of ``dtype``:
    rounded to that dtype (a 0-dim CPU tensor, usable with any device)."""
    return torch.tensor(value, dtype=dtype)


def row_sum(x2: torch.Tensor) -> torch.Tensor:
    """(rows, CHUNK) f32 -> (rows,) by pairwise halving: column j adds
    column j + width/2 until one column is left."""
    n = x2.shape[1]
    while n > 1:
        n //= 2
        x2 = x2[:, :n] + x2[:, n:]
    return x2[:, 0]


def decay(g: torch.Tensor, p: torch.Tensor, wd: float,
          cast_g_first: bool) -> torch.Tensor:
    """g + wd*p in f32 with the reference paths' cast order (SNGM/MSGD
    decay in the gradient dtype, then cast; LARS casts g first).  wd == 0
    is a true no-op: ``+0*p`` would flip the sign of -0.0."""
    if wd == 0.0:
        return g.float()
    wp = weak_scalar(wd, p.dtype) * p
    if cast_g_first:
        return g.float() + wp
    return (g + wp).float()


def chunk_sumsq_ref(x: torch.Tensor, p=None, *, wd: float = 0.0) -> torch.Tensor:
    """Per-row sum of squares of ``x`` (or of ``decay(x, p)``); flat
    (n,) in, (n / CHUNK,) f32 out."""
    x2 = x.view(-1, CHUNK)
    if p is None or wd == 0.0:
        ge = x2.float()
    else:
        ge = decay(x2, p.view(-1, CHUNK), wd, cast_g_first=False)
    return row_sum(ge * ge)


def fused_update_ref(p, g, u, a_chunk, c, *, beta: float, wd: float,
                     cast_g_first: bool = False, nesterov: bool = False,
                     apply: bool = True):
    """Returns (first, u_new [f32], usq [(n / CHUNK,) f32]) as new
    tensors; ``c`` is a 0-dim f32 tensor (the schedule's lr).  ``first``
    is p_new [p.dtype], or with ``apply=False`` (the deferred apply of a
    trailing clip) the f32 effective direction ``out`` (``u_new``, or the
    nesterov look-ahead) while p is only read for the decay.  usq holds
    the row sums of squares of ``out`` either way."""
    p2 = p.view(-1, CHUNK)
    ge = decay(g.view(-1, CHUNK), p2, wd, cast_g_first)
    a = a_chunk.view(-1, 1)
    u_new = beta * u.view(-1, CHUNK) + a * ge
    out = beta * u_new + a * ge if nesterov else u_new
    first = (p2 - c * out).to(p.dtype) if apply else out
    return first.view(-1), u_new.view(-1), row_sum(out * out)


def scale_apply_ref(p, g, a_chunk, c):
    """LAMB's apply: ``s = a*g`` per row, ``p_new = (p - c*s).to(p.dtype)``.
    Returns (p_new, (n / CHUNK,) f32 row sums of s^2) as new tensors; ``g``
    is the f32 direction, ``c`` a 0-dim f32 tensor (the lr)."""
    s = a_chunk.view(-1, 1) * g.view(-1, CHUNK)
    p_new = (p.view(-1, CHUNK) - c * s).to(p.dtype)
    return p_new.view(-1), row_sum(s * s)


def adam_update_ref(p, g, m, v, bc1, bc2, *, b1: float, b2: float,
                    eps: float, wd: float = 0.0):
    """Both f32 Adam moments and the bias-corrected, decoupled-decayed
    direction ``u = (m'/bc1) / (sqrt(v'/bc2) + eps) + wd*p``.  Returns
    (m_new, v_new, u, usq, psq, gsq) as new tensors: flat f32 buffers and
    (n / CHUNK,) f32 row sums of u^2, p^2 and g^2.  ``bc1``/``bc2`` are
    0-dim f32 tensors (``1 - b**t``).  They divide as tensors on ``m``'s
    device: PyTorch's CUDA division by a CPU scalar multiplies by its
    reciprocal, which is not the division the kernel and JAX do."""
    bc1 = bc1.to(device=m.device, dtype=torch.float32)
    bc2 = bc2.to(device=m.device, dtype=torch.float32)
    p2 = p.view(-1, CHUNK)
    g32 = g.view(-1, CHUNK).float()
    gsq = row_sum(g32 * g32)
    m_new = b1 * m.view(-1, CHUNK) + (1 - b1) * g32
    v_new = b2 * v.view(-1, CHUNK) + (1 - b2) * (g32 * g32)
    u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    if wd != 0.0:
        u = u + weak_scalar(wd, p.dtype) * p2
    pf = p2.float()
    return (m_new.view(-1), v_new.view(-1), u.view(-1), row_sum(u * u),
            row_sum(pf * pf), gsq)
