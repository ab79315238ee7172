"""The per-leaf LARS passes: dispatch on the tensor's device.

A CPU tensor runs the plain version (``ref.py``).  A CUDA tensor launches
the hand-written kernels (``csrc/fused_lars.cu``, built for sm_90a at
first use) or raises: there is no fallback on the card.  Each launch adds
one to ``repro_torch.kernels.LAUNCHES`` under ``lars_sqnorm`` or
``lars_update``.

``lars_update`` is one tensor's LARS step as the JAX package's
``repro.kernels.fused_lars.ops.lars_update`` runs it: two norm launches
and one update launch, ``w`` and ``v`` updated in place.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core.multi_tensor import _fold_sum
from repro_torch.kernels import on_cuda, record_call, record_launch
from repro_torch.kernels.build import Library, build_library
from repro_torch.kernels.fused_lars.ref import lars_sqnorm_ref, lars_update_ref
from repro_torch.kernels.fused_sngm.ops import check_leaf, device_scalar
from repro_torch.kernels.multi_tensor.ref import CHUNK, weak_scalar

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_lars.cu"
LIB_NAME = "fused_lars"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def library() -> Library:
    """Build (once) and load the kernels' shared library."""
    built = build_library(LIB_NAME, [SOURCE])
    lib = built.lib
    if not lib.lars_sqnorm.argtypes:
        P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.lars_sqnorm.argtypes = [I, P, L, P, L, P]
        lib.lars_sqnorm.restype = I
        lib.lars_update.argtypes = [I, I, P, P, P, P, F, F, L, P]
        lib.lars_update.restype = I
        lib.lars_error_string.argtypes = [I]
        lib.lars_error_string.restype = ctypes.c_char_p
    return built


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.lars_error_string(err).decode()}")


def lars_sqnorm(x: torch.Tensor) -> torch.Tensor:
    """One tensor's (max(1, ceil(n / CHUNK)),) f32 row sums of x^2."""
    record_call("lars_sqnorm")
    if not on_cuda(x, "lars_sqnorm"):
        return lars_sqnorm_ref(x)
    check_leaf("x", x, _DTYPE_CODES, x)
    n_rows = max(1, -(-x.numel() // CHUNK))
    out = torch.empty(n_rows, dtype=torch.float32, device=x.device)
    lib = library().lib
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lars_sqnorm(_DTYPE_CODES[x.dtype], x.data_ptr(), x.numel(),
                              out.data_ptr(), n_rows, stream)
    _raise_on(lib, err, "lars_sqnorm")
    record_launch("lars_sqnorm")
    return out


def fused_lars_update(w: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
                      lr_local: torch.Tensor, *, beta: float,
                      wd: float) -> None:
    """One tensor, in place: ``v <- beta*v + lr_local*(g + wd*w)``,
    ``w <- (w - v).to(w.dtype)``.  ``lr_local`` is a 0-dim f32 tensor (on
    the card it stays there: the kernel reads it through its pointer)."""
    record_call("lars_update")
    if not on_cuda(w, "fused_lars_update"):
        w_new, v_new = lars_update_ref(w, g, v, lr_local, beta=beta, wd=wd)
        w.copy_(w_new)
        v.copy_(v_new)
        return
    check_leaf("w", w, _DTYPE_CODES, w)
    check_leaf("g", g, _DTYPE_CODES, w)
    check_leaf("v", v, (torch.float32,), w)
    a = device_scalar("lr_local", lr_local, w.device)
    lib = library().lib
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.lars_update(_DTYPE_CODES[w.dtype], _DTYPE_CODES[g.dtype],
                              w.data_ptr(), g.data_ptr(), v.data_ptr(),
                              a.data_ptr(), float(beta),
                              float(weak_scalar(wd, w.dtype)), w.numel(),
                              stream)
    _raise_on(lib, err, "lars_update")
    record_launch("lars_update")


def lars_update(w: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
                lr: torch.Tensor, *, beta: float, wd: float,
                trust: float = 0.001, eps: float = 1e-12) -> None:
    """One tensor's LARS step in place (3 launches on the card):
    ``local = trust*||w|| / (||g|| + wd*||w|| + eps)`` (1 where
    ``||w|| == 0``), then ``fused_lars_update`` with ``lr*local``.  The
    norms fold the row sums as ``leaf_sumsq`` does."""
    wn = torch.sqrt(_fold_sum(lars_sqnorm(w)))
    gn = torch.sqrt(_fold_sum(lars_sqnorm(g)))
    local = trust * wn / (gn + wd * wn + eps)
    local = torch.where(wn > 0, local, 1.0)
    fused_lars_update(w, g, v, lr * local, beta=beta, wd=wd)
