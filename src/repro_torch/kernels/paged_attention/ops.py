"""Paged decode attention: dispatch on the tensor's device.

A CPU tensor runs the plain version (``ref.py``).  A CUDA tensor
launches the hand-written kernel (``csrc/paged_attention.cu``, built
for sm_90a at first use) or raises: there is no fallback on the card.
The kernel decodes split-KV: ``split_plan`` cuts each sequence's table
into splits from the shapes alone, and the last block of a sequence's
kv head merges the splits in a fixed order, one launch a call.  Each
launch adds one to ``repro_torch.kernels.LAUNCHES``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import record_call, record_launch
from repro_torch.kernels.build import Library, build_library
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
NAME = "paged_decode_attention"
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 8                    # query heads per kv head (kMaxG)
MAX_SPLIT_LEN = 512              # positions a split holds (kMaxSplitLen)
PART_HEADER = 16                 # floats before a partial's acc (kHeader)
MERGE_GROUP = 16                 # live splits merged together first (kGroup)
MAX_SPLITS = MERGE_GROUP * 256   # kGroup * kMaxMerge
LONG_TABLE = 2048                # from here on a split holds 64 positions or more
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SM_COUNT = {}                   # device index -> SMs
_PLANS = {}                      # (device, stream, shapes, split_len) -> _plan


def library() -> Library:
    """Build (once) and load the kernel's shared library."""
    built = build_library("paged_attention", [SOURCE])
    fn = built.lib.paged_decode_attention_launch
    if not fn.argtypes:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [I, P, P, P, P, P, P,            # dtype, q, kp, vp, bt, pos, o
                       P, P,                           # partials, tickets
                       I, I, I, I, I, I, I,            # B, H, K, hd, bs, nbmax, nb
                       L, L, L, L, L, L,               # pool strides
                       I, ctypes.c_float, ctypes.c_float,  # window, softcap, scale
                       I, I, P]                        # split_len, n_split, stream
        fn.restype = ctypes.c_int
        built.lib.paged_sm_count.argtypes = [I]
        built.lib.paged_sm_count.restype = I
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


def split_plan(T: int, bs: int, BK: int, sms: int):
    """(split_len, n_split) for a table of T = nbmax * bs positions and
    B * K = BK (sequence, kv head) rows on a card of ``sms`` SMs, from
    the shapes alone (reading pos would make the host wait on the card).
    At most one wave of blocks (a second, partial wave would leave the
    SMs that hold two blocks the last to finish, and every split more
    adds a partial to merge); a split holds at least one pool block and
    32 positions, 64 from a table of LONG_TABLE positions on (so its
    partial stays small next to its K/V), and at most MAX_SPLIT_LEN."""
    want = max(1, sms // BK)                         # splits for one wave
    floor = max(bs, 64 if T >= LONG_TABLE else 32)
    split_len = min(max(-(-T // want), floor), MAX_SPLIT_LEN, T)
    return split_len, -(-T // split_len)


def sm_count(device: torch.device) -> int:
    """SMs of a CUDA device, read once (cudaDevAttrMultiProcessorCount)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SM_COUNT:
        n = library().lib.paged_sm_count(index)
        if n <= 0:
            raise RuntimeError(f"cannot read the SM count of cuda:{index}")
        _SM_COUNT[index] = n
    return _SM_COUNT[index]


def _plan(device, B, H, K, hd, bs, nbmax, split_len):
    """(split_len, n_split, partials, tickets) of one launch shape on one
    stream: the split plan (``split_plan`` where split_len is None), its
    fp32 scratch for the partials and its zeroed int32 merge tickets,
    which the kernel leaves zeroed.  Launches on one stream run in order,
    so calls of one shape share them."""
    T = nbmax * bs
    if split_len is None:
        split_len, _ = split_plan(T, bs, B * K, sm_count(device))
    n_split = -(-T // split_len)
    if n_split > MAX_SPLITS:
        raise ValueError(f"a table of {T} positions needs {n_split} splits of "
                         f"{split_len}; the kernel merges at most {MAX_SPLITS}")
    n_groups = -(-n_split // MERGE_GROUP)
    gp = 1 << (H // K - 1).bit_length()
    part = torch.empty(B * K * (n_split + n_groups) * (PART_HEADER + gp * hd)
                       if n_split > 1 else 0, dtype=torch.float32, device=device)
    tickets = torch.zeros(B * K * (1 + n_groups), dtype=torch.int32, device=device)
    return split_len, n_split, part, tickets


def paged_attention(q, kp, vp, bt, pos, *, window: int = 0,
                    softcap: float = 0.0):
    """q (B, H, hd); kp/vp (n_blocks, bs, K, hd) pools; bt (B, nbmax)
    int32; pos (B,) int32.  Returns (B, H, hd) in q.dtype."""
    record_call(NAME)
    if q.device.type == "cpu":
        return paged_attention_ref(q, kp, vp, bt, pos, window=window,
                                   softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, not {q.device}")
    _check(q, kp, vp, bt, pos)
    return launch_split(q, kp, vp, bt, pos, window=window, softcap=softcap)


def launch_split(q, kp, vp, bt, pos, *, window: int = 0, softcap: float = 0.0,
                 split_len: int | None = None):
    """Launch the kernel on CUDA tensors that pass ``_check``, with splits
    of ``split_len`` positions (at most MAX_SPLIT_LEN; None: the
    wrapper's ``split_plan``)."""
    B, H, hd = q.shape
    nb, bs, K, _ = kp.shape
    o = torch.empty_like(q)
    if B == 0 or bt.shape[1] == 0:
        return o
    lib = library().lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        key = (q.device.index, stream, B, H, K, hd, bs, bt.shape[1], split_len)
        plan = _PLANS.get(key)
        if plan is None:
            plan = _PLANS[key] = _plan(q.device, B, H, K, hd, bs, bt.shape[1], split_len)
        split_len, n_split, part, tickets = plan
        err = lib.paged_decode_attention_launch(
            _DTYPE_CODES[q.dtype], q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
            bt.data_ptr(), pos.data_ptr(), o.data_ptr(), part.data_ptr(),
            tickets.data_ptr(), B, H, K, hd, bs, bt.shape[1], nb,
            *kp.stride()[:3], *vp.stride()[:3], int(window), float(softcap),
            float(hd ** -0.5), split_len, n_split, stream)
    if err != 0:
        raise RuntimeError(f"{NAME} launch failed: "
                           f"{lib.repro_cuda_error_string(err).decode()}")
    record_launch(NAME)
    return o
