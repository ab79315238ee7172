"""RMSNorm: dispatch on the tensor's device.

The port's counterpart of ``repro.kernels.rmsnorm.ops.rmsnorm``.  A CPU
tensor runs the plain version (``ref.py``).  A CUDA tensor launches the
hand-written kernel (``csrc/rmsnorm.cu``, built for sm_90a at first use)
or raises: there is no fallback on the card.  Each launch adds one to
``repro_torch.kernels.LAUNCHES["rmsnorm"]``.

The kernel reads each row once: a warp holds a row of up to 2048 fp32
or 4096 bf16 in registers, a block stages a wider one in shared memory.
``load_pack`` picks how many elements one load moves.  No entry point of
the port calls it, as none of the JAX package calls ``rmsnorm_pallas``:
the models normalise with ``layers.rmsnorm``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import on_cuda, record_call, record_launch
from repro_torch.kernels.build import Library, build_library
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"
LIB_NAME = "rmsnorm"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def library() -> Library:
    """Build (once) and load the kernel's shared library."""
    built = build_library(LIB_NAME, [SOURCE])
    lib = built.lib
    if not lib.rmsnorm_launch.argtypes:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.rmsnorm_launch.argtypes = [I, I, P, P, P, ctypes.c_longlong, I,
                                       ctypes.c_float, I, P]
        lib.rmsnorm_launch.restype = I
        lib.rmsnorm_error_string.argtypes = [I]
        lib.rmsnorm_error_string.restype = ctypes.c_char_p
    return built


def load_pack(d: int, x: torch.Tensor, scale: torch.Tensor, o: torch.Tensor) -> int:
    """Elements the kernel moves with one load: 16 bytes of x (4 fp32 or
    8 bf16), else (bf16) 8 bytes, else 1; the widest that d is a multiple
    of and that x, o and scale start aligned to."""
    for pack in (16 // x.element_size(), 4, 1):
        if d % pack == 0 and all(t.data_ptr() % min(16, pack * t.element_size()) == 0
                                 for t in (x, scale, o)):
            return pack
    return 1


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """x (..., d), scale (d,) -> x's shape and dtype:
    ``x * rsqrt(mean(x**2, -1) + eps) * scale``, fp32 inside."""
    record_call("rmsnorm")
    if not on_cuda(x, "rmsnorm"):
        return rmsnorm_ref(x, scale, eps)
    d = x.shape[-1] if x.dim() else 0
    if tuple(scale.shape) != (d,) or d == 0:
        raise ValueError(f"x {tuple(x.shape)}, scale {tuple(scale.shape)}: "
                         f"scale must be (d,) for the last dim d > 0 of x")
    if x.dtype not in _DTYPE_CODES or scale.dtype not in _DTYPE_CODES:
        raise TypeError(f"dtypes x {x.dtype}, scale {scale.dtype}: each one "
                        f"of {list(_DTYPE_CODES)}")
    if scale.device != x.device:
        raise ValueError(f"scale is on {scale.device}, x on {x.device}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("x and scale must be contiguous")
    o = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return o
    pack = load_pack(d, x, scale, o)
    lib = library().lib
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rmsnorm_launch(_DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype],
                                 x.data_ptr(), scale.data_ptr(), o.data_ptr(),
                                 rows, d, float(eps), pack, stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm launch failed: "
                           f"{lib.rmsnorm_error_string(err).decode()}")
    record_launch("rmsnorm")
    return o
