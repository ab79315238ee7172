"""Forward flash attention: dispatch on the tensor's device.

The port's counterpart of ``repro.kernels.flash_attention.ops.attention``.
A CPU tensor runs the plain version (``ref.py``).  A CUDA tensor launches
the hand-written kernel (``csrc/flash_attention.cu``, built for sm_90a at
first use) or raises: there is no fallback on the card.  Each launch adds
one to ``repro_torch.kernels.LAUNCHES["flash_attention"]``.

``q_blk`` and ``kv_blk`` are the kernel's query and key tile sizes; the
library is built for 64 x 64 only (the TPU kernel's defaults, 256 and
512, do not fit in a Hopper block's shared memory at fp32).  The plain version does not tile,
so on the CPU they are not read.  There is no backward, as the TPU
kernel has none, and no entry point of the port calls it, as none of the
JAX package calls ``flash_attention``: the models attend with
``layers._sdpa_seq``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import on_cuda, record_launch
from repro_torch.kernels.build import Library, build_library
from repro_torch.kernels.flash_attention.ref import attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
LIB_NAME = "flash_attention"
HEAD_DIMS = (64, 128, 256)
TILES = (64,)
DEFAULT_Q_BLK = 64
DEFAULT_KV_BLK = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def library() -> Library:
    """Build (once) and load the kernel's shared library."""
    built = build_library(LIB_NAME, [SOURCE])
    lib = built.lib
    if not lib.flash_attention_launch.argtypes:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_launch.argtypes = [I, P, P, P, P, I, I, I, I, I,
                                               I, I, I, I, F, F, P]
        lib.flash_attention_launch.restype = I
        lib.flash_attention_error_string.argtypes = [I]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return built


def _check(q, k, v, window, q_blk, kv_blk):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[:2] != (B, S) or k.shape[3] != hd:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    K = k.shape[2]
    if K == 0 or H % K:
        raise ValueError(f"H={H}, K={K}: need K | H")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the kernel takes {HEAD_DIMS}")
    if q_blk not in TILES or kv_blk not in TILES:
        raise ValueError(f"q_blk {q_blk}, kv_blk {kv_blk}: each one of {TILES}")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes q {q.dtype} k {k.dtype} v {v.dtype}: one of "
                        f"{list(_DTYPE_CODES)} for all three")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"{name} must be contiguous and aligned to 4 elements")


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              softcap: float = 0.0, q_blk: int = DEFAULT_Q_BLK,
              kv_blk: int = DEFAULT_KV_BLK):
    """q (B, S, H, hd); k/v (B, S, K, hd) with K | H.  Returns (B, S, H,
    hd) in q.dtype."""
    if not on_cuda(q, "flash_attention"):
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    _check(q, k, v, window, q_blk, kv_blk)
    B, S, H, hd = q.shape
    o = torch.empty_like(q)
    if B == 0 or S == 0:
        return o
    lib = library().lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), B, S, H, k.shape[2], hd, q_blk, kv_blk, int(causal),
            int(window), float(softcap), float(hd ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()}")
    record_launch("flash_attention")
    return o
