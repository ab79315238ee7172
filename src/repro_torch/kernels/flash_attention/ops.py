"""Forward flash attention: dispatch on the tensor's device.

The port's counterpart of ``repro.kernels.flash_attention.ops.attention``.
A CPU tensor runs the plain version (``ref.py``).  A CUDA tensor launches
the hand-written kernel (``csrc/flash_attention.cu``, built for sm_90a at
first use) or raises: there is no fallback on the card.  Each launch adds
one to ``repro_torch.kernels.LAUNCHES["flash_attention"]``.

``q_blk`` and ``kv_blk`` are the kernel's query and key tile sizes, one
pair per (dtype, head dim), in ``TILES``; None (the default) takes that
pair, and any other pair raises.  fp32 runs on the tensor cores in
3xTF32 (wgmma; each operand split into two TF32 terms, three
products), two warpgroups a block: 128 queries (64 each) and 64 keys a
tile at hd 64, 32 keys at hd 128; at hd 256 64 queries (each warpgroup
on half the head dim) and 32 keys; K/V by cp.async, split once a tile
in shared memory (the TPU kernel's defaults, 256 and 512, do not fit in
a Hopper block's shared memory at fp32).  bf16 runs on the tensor cores
(wgmma, K/V by TMA) with 128 queries a block (64 a warpgroup) and 64
keys a tile, 128 at hd 64.  ``smem_bytes`` is the shared memory a block
takes, as the launcher computes it.  The plain version does not tile, so
on the CPU the tiles are not read.  There is no backward, as the TPU
kernel has none, and no entry point of the port calls it, as none of the
JAX package calls ``flash_attention``: the models attend with
``layers._sdpa_seq``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import on_cuda, record_call, record_launch
from repro_torch.kernels.build import Library, build_library
from repro_torch.kernels.flash_attention.ref import attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
LIB_NAME = "flash_attention"
HEAD_DIMS = (64, 128, 256)
# (q_blk, kv_blk) of each dtype's kernel at each head dim
TILES = {torch.float32: {64: (128, 64), 128: (128, 32), 256: (64, 32)},
         torch.bfloat16: {64: (128, 128), 128: (128, 64), 256: (128, 64)}}
# fp32: warpgroups that share the block's query rows, each on hd / n of
# the head dim (hd 256: Q raw, split at each use); below it each takes 64
# rows of 128 over the whole head dim, Q split once
FP32_HEAD_SPLIT = {64: 1, 128: 1, 256: 2}
DEFAULT_Q_BLK = None               # TILES' pair for the inputs
DEFAULT_KV_BLK = None
SMEM_LIMIT = 232448                # shared memory a Hopper block can use
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes(dtype, hd: int, q_blk: int, kv_blk: int) -> int:
    """Dynamic shared memory of one block, as ``flash_attention.cu``
    sizes it: fp32, Q split into hi and lo (hd 64, 128; raw in rows
    padded by 4 floats at hd 256), a K tile and V^T split likewise, raw V
    in rows padded by 4 floats and 1024 bytes to align the tiles; bf16, Q
    and two stages of K and V tiles, three 8-byte mbarriers, two counts
    and 1024 bytes to align the tiles."""
    if dtype == torch.float32:
        q_bytes = 2 * q_blk * hd if FP32_HEAD_SPLIT[hd] == 1 else q_blk * (hd + 4)
        return 4 * (q_bytes + 4 * kv_blk * hd + kv_blk * (hd + 4)) + 1024
    return 2 * hd * (q_blk + 2 * 2 * kv_blk) + 32 + 1024


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
    """Raise on what the kernel does not take; return the (q_blk, kv_blk)
    to launch with."""
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
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes q {q.dtype} k {k.dtype} v {v.dtype}: one of "
                        f"{list(_DTYPE_CODES)} for all three")
    want = TILES[q.dtype][hd]
    tiles = (want[0] if q_blk is None else q_blk, want[1] if kv_blk is None else kv_blk)
    if tiles != want:
        raise ValueError(f"q_blk {q_blk}, kv_blk {kv_blk}: the {q.dtype} kernel "
                         f"at hd {hd} takes {want}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return tiles


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              softcap: float = 0.0, q_blk: int | None = DEFAULT_Q_BLK,
              kv_blk: int | None = DEFAULT_KV_BLK):
    """q (B, S, H, hd); k/v (B, S, K, hd) with K | H.  Returns (B, S, H,
    hd) in q.dtype."""
    record_call("flash_attention")
    if not on_cuda(q, "flash_attention"):
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    q_blk, kv_blk = _check(q, k, v, window, q_blk, kv_blk)
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
