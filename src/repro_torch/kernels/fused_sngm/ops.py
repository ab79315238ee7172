"""The per-leaf SNGM update: dispatch on the tensor's device.

A CPU tensor runs the plain version (``ref.py``).  A CUDA tensor launches
the hand-written kernel (``csrc/fused_sngm.cu``, built for sm_90a at
first use) or raises: there is no fallback on the card.  Each launch adds
one to ``repro_torch.kernels.LAUNCHES["fused_sngm_update"]``.

``fused_sngm_tree`` is the one-launch-per-tensor baseline the
multi-tensor engine is measured against (``repro.kernels.fused_sngm.ops``):
one launch per leaf, in the JAX tree's leaf order.  ``p`` and ``u`` are
updated in place on either device.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.core.multi_tensor import leaf_order
from repro_torch.kernels import on_cuda, record_call, record_launch
from repro_torch.kernels.build import Library, build_library
from repro_torch.kernels.fused_sngm.ref import sngm_update_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_sngm.cu"
LIB_NAME = "fused_sngm"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
Tree = Dict[str, torch.Tensor]


def library() -> Library:
    """Build (once) and load the kernel's shared library."""
    built = build_library(LIB_NAME, [SOURCE])
    lib = built.lib
    if not lib.sngm_update.argtypes:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sngm_update.argtypes = [I, I, P, P, P, P, F, F, ctypes.c_longlong, P]
        lib.sngm_update.restype = I
        lib.sngm_error_string.argtypes = [I]
        lib.sngm_error_string.restype = ctypes.c_char_p
    return built


def check_leaf(name: str, t: torch.Tensor, dtypes, like: torch.Tensor) -> None:
    """What the per-leaf kernels take: a contiguous, 16-byte aligned tensor
    of ``like``'s shape, on its device, in one of ``dtypes``."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {list(dtypes)}")
    if t.shape != like.shape or t.device != like.device:
        raise ValueError(f"{name}: {tuple(t.shape)} on {t.device}, expected "
                         f"{tuple(like.shape)} on {like.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def device_scalar(name: str, x: torch.Tensor, device) -> torch.Tensor:
    """A one-element f32 tensor on ``device`` whose pointer a kernel reads."""
    if x.numel() != 1 or x.dtype != torch.float32:
        raise ValueError(f"{name} must be a one-element f32 tensor")
    return x.to(device).contiguous()


def fused_sngm_update(p: torch.Tensor, g: torch.Tensor, u: torch.Tensor,
                      inv_norm: torch.Tensor, lr: torch.Tensor, *,
                      beta: float) -> None:
    """One leaf, in place: ``u <- beta*u + g*inv_norm``,
    ``p <- (p - lr*u).to(p.dtype)``.  ``inv_norm`` is a 0-dim f32 tensor
    (on the card it stays there: the kernel reads it through its
    pointer), ``lr`` a 0-dim f32 CPU tensor."""
    record_call("fused_sngm_update")
    if not on_cuda(p, "fused_sngm_update"):
        p_new, u_new = sngm_update_ref(p, g, u, inv_norm, lr, beta=beta)
        p.copy_(p_new)
        u.copy_(u_new)
        return
    check_leaf("p", p, _DTYPE_CODES, p)
    check_leaf("g", g, _DTYPE_CODES, p)
    check_leaf("u", u, (torch.float32,), p)
    inv = device_scalar("inv_norm", inv_norm, p.device)
    if lr.numel() != 1 or lr.device.type != "cpu":
        raise ValueError("lr must be a one-element CPU tensor")
    lib = library().lib
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.sngm_update(_DTYPE_CODES[p.dtype], _DTYPE_CODES[g.dtype],
                              p.data_ptr(), g.data_ptr(), u.data_ptr(),
                              inv.data_ptr(), float(lr), float(beta),
                              p.numel(), stream)
    if err != 0:
        raise RuntimeError(f"fused_sngm_update launch failed: "
                           f"{lib.sngm_error_string(err).decode()}")
    record_launch("fused_sngm_update")


def fused_sngm_tree(params: Tree, grads: Tree, momentum: Tree,
                    inv_norm: torch.Tensor, beta: float,
                    lr: torch.Tensor) -> Tuple[Tree, Tree]:
    """``fused_sngm_update`` on every leaf, one launch each, in the JAX
    tree's leaf order; returns (params, momentum), updated in place."""
    for k in leaf_order(params):
        fused_sngm_update(params[k], grads[k], momentum[k], inv_norm, lr,
                          beta=beta)
    return params, momentum
