"""The multi-tensor optimizer passes: dispatch on the tensor's device.

A CPU tensor runs the plain version (``ref.py``).  A CUDA tensor launches
the hand-written kernel (``csrc/multi_tensor.cu``, built for sm_90a at
first use) or raises: there is no fallback on the card.  Each kernel
launch adds one to ``repro_torch.kernels.LAUNCHES``, each call (on either
device) one to ``CALLS``.

The wrappers keep the TPU kernels' contract (``repro.kernels.
multi_tensor.kernel``): flat buffers of a TILE multiple of elements, one
f32 coefficient and one f32 partial per CHUNK row.  They update in place
on either device where the JAX package declares input/output aliases:
``p`` and ``u`` for ``fused_update`` (``u`` only with ``apply=False``),
``m`` and ``v`` for ``adam_update``, ``p`` for ``scale_apply``.
``fused_update``'s deferred-apply mode counts its launches under its own
name, ``fused_update_deferred``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import on_cuda, record_call, record_launch
from repro_torch.kernels.build import Library, build_library
from repro_torch.kernels.multi_tensor.ref import (CHUNK, TILE,
                                                  adam_update_ref,
                                                  chunk_sumsq_ref,
                                                  fused_update_ref,
                                                  scale_apply_ref,
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
        lib.mt_chunk_sumsq.argtypes = [I, I, P, P, F, P, L, P]
        lib.mt_chunk_sumsq.restype = I
        lib.mt_fused_update.argtypes = [I, I, P, P, P, P, F, F, F, I, I, P, P,
                                        L, P]
        lib.mt_fused_update.restype = I
        lib.mt_scale_apply.argtypes = [I, P, P, P, F, P, L, P]
        lib.mt_scale_apply.restype = I
        lib.mt_adam_update.argtypes = [I, I, P, P, P, P, P, P, P, P,
                                       F, F, F, F, F, F, F, F, I, L, P]
        lib.mt_adam_update.restype = I
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


def _check_rows(name: str, a: torch.Tensor, n_rows: int, device) -> None:
    if (a.dtype != torch.float32 or tuple(a.shape) != (n_rows,)
            or a.device != device or not a.is_contiguous()):
        raise ValueError(f"{name}: {a.dtype} {tuple(a.shape)} on {a.device}; "
                         f"need contiguous f32 ({n_rows},) on {device}")


def _check_scalar(name: str, c: torch.Tensor) -> None:
    if c.numel() != 1 or c.dtype != torch.float32 or c.device.type != "cpu":
        raise ValueError(f"{name} must be a one-element f32 CPU tensor")


def _grad_dtypes(p: torch.Tensor):
    """The types a gradient buffer may have beside params ``p``: p's own,
    or fp32 where a chain stage before the engine promoted the update."""
    return (p.dtype, torch.float32)


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.mt_error_string(err).decode()}")


def chunk_sumsq(x: torch.Tensor, p: Optional[torch.Tensor] = None, *,
                wd: float = 0.0) -> torch.Tensor:
    """Per-CHUNK-row sum of squares of ``x``, or of ``x + wd*p`` (cast
    after the sum) when ``p`` is given and wd != 0; ``x`` has p's type or
    fp32.  Returns (n/CHUNK,) f32."""
    record_call("chunk_sumsq")
    if not on_cuda(x, "chunk_sumsq"):
        return chunk_sumsq_ref(x, p, wd=wd)
    decayed = p is not None and wd != 0.0
    _check_flat("x", x, _DTYPE_CODES, x.device)
    if decayed:
        _check_flat("p", p, _DTYPE_CODES, x.device)
        if x.dtype not in _grad_dtypes(p):
            raise TypeError(f"x: dtype {x.dtype} beside p {p.dtype}")
        if p.numel() != x.numel():
            raise ValueError(f"p has {p.numel()} elements, x {x.numel()}")
    n_rows = x.numel() // CHUNK
    out = torch.empty(n_rows, dtype=torch.float32, device=x.device)
    lib = library().lib
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mt_chunk_sumsq(
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[p.dtype if decayed else x.dtype],
            x.data_ptr(), p.data_ptr() if decayed else None,
            float(weak_scalar(wd, p.dtype if decayed else x.dtype)),
            out.data_ptr(), n_rows, stream)
    _raise_on(lib, err, "chunk_sumsq")
    record_launch("chunk_sumsq")
    return out


def fused_update(p: torch.Tensor, g: torch.Tensor, u: torch.Tensor,
                 a_chunk: torch.Tensor, c: torch.Tensor, *, beta: float,
                 wd: float, cast_g_first: bool = False,
                 nesterov: bool = False, apply: bool = True,
                 out: Optional[torch.Tensor] = None):
    """Momentum + apply over one bucket, in place:
    ``u <- beta*u + a*decay(g, p)``, ``p <- (p - c*out).to(p.dtype)`` with
    ``out = beta*u_new + a*decay(g, p)`` under nesterov, else ``u_new``.
    ``c`` is a 0-dim f32 tensor; ``g`` has p's type or fp32.  Returns the
    (n/CHUNK,) f32 row sums of squares of ``out``.

    ``apply=False`` defers the apply (a trailing clip rescales the step
    first): ``p`` is read for the decay only and never written, ``out``
    goes into the given contiguous f32 (n,) buffer or a fresh one, and
    the call returns ``(out, row sums)``."""
    if apply and out is not None:
        raise ValueError("out is the deferred direction: only with apply=False")
    record_call("fused_update" if apply else "fused_update_deferred")
    if not on_cuda(p, "fused_update"):
        first, u_new, usq = fused_update_ref(
            p, g, u, a_chunk, c, beta=beta, wd=wd, cast_g_first=cast_g_first,
            nesterov=nesterov, apply=apply)
        if apply:
            p.copy_(first)
            u.copy_(u_new)
            return usq
        out = first if out is None else out.copy_(first)
        u.copy_(u_new)
        return out, usq
    _check_flat("p", p, _DTYPE_CODES, p.device)
    _check_flat("g", g, _grad_dtypes(p), p.device)
    _check_flat("u", u, (torch.float32,), p.device)
    n_rows = p.numel() // CHUNK
    if g.numel() != p.numel() or u.numel() != p.numel():
        raise ValueError(f"p {p.numel()}, g {g.numel()}, u {u.numel()} elements")
    _check_rows("a_chunk", a_chunk, n_rows, p.device)
    _check_scalar("c", c)
    if not apply:
        if out is None:
            out = torch.empty(p.numel(), dtype=torch.float32, device=p.device)
        _check_flat("out", out, (torch.float32,), p.device)
        if out.numel() != p.numel():
            raise ValueError(f"out has {out.numel()} elements, p {p.numel()}")
        if out.data_ptr() in (p.data_ptr(), g.data_ptr(), u.data_ptr()):
            raise ValueError("out must not share memory with p, g or u")
    mode = (_DECAY_NONE if wd == 0.0 else
            _DECAY_CAST_FIRST if cast_g_first else _DECAY_CAST_AFTER)
    usq = torch.empty(n_rows, dtype=torch.float32, device=p.device)
    lib = library().lib
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.mt_fused_update(
            _DTYPE_CODES[p.dtype], _DTYPE_CODES[g.dtype], p.data_ptr(),
            g.data_ptr(), u.data_ptr(),
            a_chunk.data_ptr(), float(c), float(beta),
            float(weak_scalar(wd, p.dtype)), mode, int(nesterov),
            None if apply else out.data_ptr(), usq.data_ptr(), n_rows, stream)
    _raise_on(lib, err, "fused_update")
    if apply:
        record_launch("fused_update")
        return usq
    record_launch("fused_update_deferred")
    return out, usq


def scale_apply(p: torch.Tensor, g: torch.Tensor, a_chunk: torch.Tensor,
                c: torch.Tensor) -> torch.Tensor:
    """LAMB's apply over one bucket, in place: ``s = a*g`` per row,
    ``p <- (p - c*s).to(p.dtype)``.  ``g`` is the f32 direction, ``c`` a
    0-dim f32 CPU tensor.  Returns the (n/CHUNK,) f32 row sums of s^2."""
    record_call("scale_apply")
    if not on_cuda(p, "scale_apply"):
        p_new, ssq = scale_apply_ref(p, g, a_chunk, c)
        p.copy_(p_new)
        return ssq
    _check_flat("p", p, _DTYPE_CODES, p.device)
    _check_flat("g", g, (torch.float32,), p.device)
    n_rows = p.numel() // CHUNK
    if g.numel() != p.numel():
        raise ValueError(f"p {p.numel()}, g {g.numel()} elements")
    _check_rows("a_chunk", a_chunk, n_rows, p.device)
    _check_scalar("c", c)
    ssq = torch.empty(n_rows, dtype=torch.float32, device=p.device)
    lib = library().lib
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.mt_scale_apply(_DTYPE_CODES[p.dtype], p.data_ptr(),
                                 g.data_ptr(), a_chunk.data_ptr(), float(c),
                                 ssq.data_ptr(), n_rows, stream)
    _raise_on(lib, err, "scale_apply")
    record_launch("scale_apply")
    return ssq


def adam_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor, *,
                b1: float, b2: float, eps: float, wd: float = 0.0):
    """LAMB's Adam pass over one bucket: advances the f32 moments ``m``
    and ``v`` in place and returns ``(u, usq, psq, gsq)``: the f32
    direction ``(m'/bc1) / (sqrt(v'/bc2) + eps) + wd*p`` as a new buffer
    and the (n/CHUNK,) f32 row sums of u^2, p^2 and g^2.  ``bc1``/``bc2``
    are 0-dim f32 CPU tensors; ``eps`` must be > 0 so that zero padding
    gives a zero direction."""
    record_call("adam_update")
    if not on_cuda(p, "adam_update"):
        m_new, v_new, u, usq, psq, gsq = adam_update_ref(
            p, g, m, v, bc1, bc2, b1=b1, b2=b2, eps=eps, wd=wd)
        m.copy_(m_new)
        v.copy_(v_new)
        return u, usq, psq, gsq
    _check_flat("p", p, _DTYPE_CODES, p.device)
    _check_flat("g", g, _grad_dtypes(p), p.device)
    _check_flat("m", m, (torch.float32,), p.device)
    _check_flat("v", v, (torch.float32,), p.device)
    if not g.numel() == m.numel() == v.numel() == p.numel():
        raise ValueError(f"p {p.numel()}, g {g.numel()}, m {m.numel()}, "
                         f"v {v.numel()} elements")
    _check_scalar("bc1", bc1)
    _check_scalar("bc2", bc2)
    n_rows = p.numel() // CHUNK
    u = torch.empty(p.numel(), dtype=torch.float32, device=p.device)
    usq, psq, gsq = torch.empty(3, n_rows, dtype=torch.float32,
                                device=p.device).unbind(0)
    lib = library().lib
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.mt_adam_update(
            _DTYPE_CODES[p.dtype], _DTYPE_CODES[g.dtype], p.data_ptr(),
            g.data_ptr(), m.data_ptr(),
            v.data_ptr(), u.data_ptr(), usq.data_ptr(), psq.data_ptr(),
            gsq.data_ptr(), float(bc1), float(bc2), b1, b2, 1 - b1, 1 - b2,
            eps, float(weak_scalar(wd, p.dtype)), int(wd != 0.0), n_rows,
            stream)
    _raise_on(lib, err, "adam_update")
    record_launch("adam_update")
    return u, usq, psq, gsq
