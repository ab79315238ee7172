"""The multi-tensor optimizer passes: dispatch on the tensor's device.

A CPU tensor runs the plain version (``ref.py``).  A CUDA tensor launches
the hand-written kernel (``csrc/multi_tensor.cu``, built for sm_90a at
first use) or raises: there is no fallback on the card.  Each kernel
launch adds one to ``repro_torch.kernels.LAUNCHES``.

Both wrappers keep the TPU kernels' contract (``repro.kernels.
multi_tensor.kernel``): flat buffers of a TILE multiple of elements, one
f32 coefficient and one f32 partial per CHUNK row.  ``fused_update``
updates ``p`` and ``u`` in place on either device, where the JAX package
declares them as input/output aliases.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import record_launch
from repro_torch.kernels.build import Library, build_library
from repro_torch.kernels.multi_tensor.ref import (CHUNK, TILE,
                                                  chunk_sumsq_ref,
                                                  fused_update_ref,
                                                  weak_scalar)

SOURCE = Path(__file__).resolve().parent / "csrc" / "multi_tensor.cu"
LIB_NAME = "multi_tensor"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DECAY_NONE, _DECAY_CAST_FIRST, _DECAY_CAST_AFTER = 0, 1, 2


def library() -> Library:
    """Build (once) and load the kernels' shared library."""
    built = build_library(LIB_NAME, [SOURCE])
    lib = built.lib
    if not lib.mt_chunk_sumsq.argtypes:
        P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.mt_chunk_sumsq.argtypes = [I, P, P, F, P, L, P]
        lib.mt_chunk_sumsq.restype = I
        lib.mt_fused_update.argtypes = [I, P, P, P, P, F, F, F, I, I, P, L, P]
        lib.mt_fused_update.restype = I
        lib.mt_error_string.argtypes = [I]
        lib.mt_error_string.restype = ctypes.c_char_p
    return built


def _check_flat(name: str, t: torch.Tensor, dtypes, device) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {list(dtypes)}")
    if t.dim() != 1 or t.numel() % TILE or t.numel() == 0:
        raise ValueError(f"{name}: shape {tuple(t.shape)}; need a flat buffer "
                         f"of a positive multiple of {TILE} elements")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.mt_error_string(err).decode()}")


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")
    return True


def chunk_sumsq(x: torch.Tensor, p: Optional[torch.Tensor] = None, *,
                wd: float = 0.0) -> torch.Tensor:
    """Per-CHUNK-row sum of squares of ``x``, or of ``x + wd*p`` (cast
    after the sum) when ``p`` is given and wd != 0.  Returns (n/CHUNK,) f32."""
    if not _on_cuda(x, "chunk_sumsq"):
        return chunk_sumsq_ref(x, p, wd=wd)
    decayed = p is not None and wd != 0.0
    _check_flat("x", x, _DTYPE_CODES, x.device)
    if decayed:
        _check_flat("p", p, (x.dtype,), x.device)
        if p.numel() != x.numel():
            raise ValueError(f"p has {p.numel()} elements, x {x.numel()}")
    n_rows = x.numel() // CHUNK
    out = torch.empty(n_rows, dtype=torch.float32, device=x.device)
    lib = library().lib
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mt_chunk_sumsq(
            _DTYPE_CODES[x.dtype], x.data_ptr(), p.data_ptr() if decayed else None,
            float(weak_scalar(wd, x.dtype)), out.data_ptr(), n_rows, stream)
    _raise_on(lib, err, "chunk_sumsq")
    record_launch("chunk_sumsq")
    return out


def fused_update(p: torch.Tensor, g: torch.Tensor, u: torch.Tensor,
                 a_chunk: torch.Tensor, c: torch.Tensor, *, beta: float,
                 wd: float, cast_g_first: bool = False,
                 nesterov: bool = False) -> torch.Tensor:
    """Momentum + apply over one bucket, in place:
    ``u <- beta*u + a*decay(g, p)``, ``p <- (p - c*out).to(p.dtype)`` with
    ``out = beta*u_new + a*decay(g, p)`` under nesterov, else ``u_new``.
    ``c`` is a 0-dim f32 tensor.  Returns the (n/CHUNK,) f32 row sums of
    squares of ``out``."""
    if not _on_cuda(p, "fused_update"):
        p_new, u_new, usq = fused_update_ref(
            p, g, u, a_chunk, c, beta=beta, wd=wd, cast_g_first=cast_g_first,
            nesterov=nesterov)
        p.copy_(p_new)
        u.copy_(u_new)
        return usq
    _check_flat("p", p, _DTYPE_CODES, p.device)
    _check_flat("g", g, (p.dtype,), p.device)
    _check_flat("u", u, (torch.float32,), p.device)
    n_rows = p.numel() // CHUNK
    if g.numel() != p.numel() or u.numel() != p.numel():
        raise ValueError(f"p {p.numel()}, g {g.numel()}, u {u.numel()} elements")
    if (a_chunk.dtype != torch.float32 or tuple(a_chunk.shape) != (n_rows,)
            or a_chunk.device != p.device or not a_chunk.is_contiguous()):
        raise ValueError(f"a_chunk: {a_chunk.dtype} {tuple(a_chunk.shape)} on "
                         f"{a_chunk.device}; need contiguous f32 ({n_rows},) "
                         f"on {p.device}")
    if c.numel() != 1 or c.dtype != torch.float32 or c.device.type != "cpu":
        raise ValueError("c must be a one-element f32 CPU tensor")
    mode = (_DECAY_NONE if wd == 0.0 else
            _DECAY_CAST_FIRST if cast_g_first else _DECAY_CAST_AFTER)
    usq = torch.empty(n_rows, dtype=torch.float32, device=p.device)
    lib = library().lib
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.mt_fused_update(
            _DTYPE_CODES[p.dtype], p.data_ptr(), g.data_ptr(), u.data_ptr(),
            a_chunk.data_ptr(), float(c), float(beta),
            float(weak_scalar(wd, p.dtype)), mode, int(nesterov),
            usq.data_ptr(), n_rows, stream)
    _raise_on(lib, err, "fused_update")
    record_launch("fused_update")
    return usq
