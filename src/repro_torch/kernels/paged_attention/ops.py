"""Paged decode attention: dispatch on the tensor's device.

A CPU tensor runs the plain version (``ref.py``).  A CUDA tensor
launches the hand-written kernel (``csrc/paged_attention.cu``, built
for sm_90a at first use) or raises: there is no fallback on the card.
Each launch adds one to ``repro_torch.kernels.LAUNCHES``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import record_launch
from repro_torch.kernels.build import Library, build_library
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
NAME = "paged_decode_attention"
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 8                    # query heads per kv head (kMaxG)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def library() -> Library:
    """Build (once) and load the kernel's shared library."""
    built = build_library("paged_attention", [SOURCE])
    fn = built.lib.paged_decode_attention_launch
    if not fn.argtypes:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [I, P, P, P, P, P, P,            # dtype, q, kp, vp, bt, pos, o
                       I, I, I, I, I, I, I,            # B, H, K, hd, bs, nbmax, nb
                       L, L, L, L, L, L,               # pool strides
                       I, ctypes.c_float, ctypes.c_float, P]
        fn.restype = ctypes.c_int
        err = built.lib.repro_cuda_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return built


def _check(q, kp, vp, bt, pos):
    if q.dim() != 3 or kp.dim() != 4 or kp.shape != vp.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} kp {tuple(kp.shape)} "
                         f"vp {tuple(vp.shape)}")
    B, H, hd = q.shape
    _, _, K, hd_k = kp.shape
    if hd_k != hd or hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} (pool {hd_k}); the kernel takes "
                         f"{HEAD_DIMS}")
    if H % K or H // K > MAX_GROUP:
        raise ValueError(f"H={H}, K={K}: need K | H and H/K <= {MAX_GROUP}")
    if q.dtype not in _DTYPE_CODES or kp.dtype != q.dtype or vp.dtype != q.dtype:
        raise TypeError(f"dtypes q {q.dtype} kp {kp.dtype} vp {vp.dtype}: "
                        f"one of {list(_DTYPE_CODES)} for all three")
    if bt.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"bt {bt.dtype} and pos {pos.dtype} must be int32")
    if bt.dim() != 2 or bt.shape[0] != B or tuple(pos.shape) != (B,):
        raise ValueError(f"bt {tuple(bt.shape)} pos {tuple(pos.shape)} for B={B}")
    for name, t in (("q", q), ("kp", kp), ("vp", vp), ("bt", bt), ("pos", pos)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if not (q.is_contiguous() and bt.is_contiguous() and pos.is_contiguous()):
        raise ValueError("q, bt and pos must be contiguous")
    align = min(16, (hd // 32) * q.element_size())
    for name, t in (("kp", kp), ("vp", vp)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous")
        if t.data_ptr() % align or any(s * t.element_size() % align
                                       for s in t.stride()[:3]):
            raise ValueError(f"{name}: rows must be {align}-byte aligned")


def paged_attention(q, kp, vp, bt, pos, *, window: int = 0,
                    softcap: float = 0.0):
    """q (B, H, hd); kp/vp (n_blocks, bs, K, hd) pools; bt (B, nbmax)
    int32; pos (B,) int32.  Returns (B, H, hd) in q.dtype."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, kp, vp, bt, pos, window=window,
                                   softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, not {q.device}")
    _check(q, kp, vp, bt, pos)
    B, H, hd = q.shape
    nb, bs, K, _ = kp.shape
    o = torch.empty_like(q)
    if B == 0:
        return o
    lib = library().lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_decode_attention_launch(
            _DTYPE_CODES[q.dtype], q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
            bt.data_ptr(), pos.data_ptr(), o.data_ptr(),
            B, H, K, hd, bs, bt.shape[1], nb, *kp.stride()[:3],
            *vp.stride()[:3], int(window), float(softcap), float(hd ** -0.5),
            stream)
    if err != 0:
        raise RuntimeError(f"{NAME} launch failed: "
                           f"{lib.repro_cuda_error_string(err).decode()}")
    record_launch(NAME)
    return o
