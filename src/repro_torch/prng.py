"""The parts of ``jax.random`` that the JAX package calls, in PyTorch.

Same bits as ``jax.random`` with the threefry-2x32 generator in its
*partitionable* layout (``jax_threefry_partitionable=True``, the default
since jax 0.5; jax 0.9.0 is what the parity tests run against).  The
non-partitionable layout of older jax (the default of the 0.4.37 that
``requirements.txt`` pins: counters ``iota(2n)`` split in halves) is not
ported; a run of the JAX package under it draws other numbers.

A key is an int64 tensor of shape ``(2,)`` holding two uint32 words, as
``jax.random.PRNGKey`` returns them; keys stay on the CPU, and a sampler
draws on the ``device`` it is given.  torch's ``uint32`` lacks most
operators, so every word is an int64 masked to 32 bits.

  * ``PRNGKey``, ``fold_in``, ``split``, ``random_bits``: bitwise;
  * ``uniform``, ``randint``: bitwise (XLA's float and modulus steps,
    op for op; XLA fuses the uniform's scale and shift into one
    multiply-add, which ``_fma32`` rounds as it does);
  * ``normal``: ``sqrt(2) * erf_inv(uniform(nextafter(-1, 0), 1))`` with
    XLA's fp32 ``erf_inv`` polynomial written out in fp32 ops.  Its
    ``log1p`` is PyTorch's, not XLA's, and XLA fuses the polynomial's
    steps into multiply-adds, so a draw can differ from
    ``jax.random.normal``'s by a few ulp (``NORMAL_ULP``, measured);
  * ``gumbel`` and ``categorical`` (``mode="low"``): ``-log(-log(u))``
    with PyTorch's ``log``; the token is the argmax, so it equals JAX's
    unless two candidates are within an ulp.

Large draws run in chunks of ``CHUNK`` elements, so the int64
temporaries stay at a few GiB whatever the shape.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch

MASK = 0xFFFFFFFF
CHUNK = 1 << 24                 # elements per chunk of a large draw
# largest |normal - jax.random.normal| in float32 ulps on the CPU, over
# the 2**24 draws of tests/test_torch_prng.py (which prints it)
NORMAL_ULP = 3

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = 1.1754943508222875e-38
_NEXTAFTER_M1 = -0.99999994039535522        # float32 nextafter(-1, 0)
# XLA's float32 erf_inv (Giles): coefficients for w < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate the 32-bit words of x left by r, in place."""
    hi = torch.bitwise_left_shift(x, r).bitwise_and_(MASK)
    return x.bitwise_right_shift_(32 - r).bitwise_or_(hi)


def threefry2x32(k0: int, k1: int, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry-2x32 hash of the counter words (x0, x1) under the key
    (k0, k1), 20 rounds as ``jax._src.prng._threefry2x32_lowering``.
    x0 and x1 are int64 tensors of words; they are overwritten."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0.add_(ks[0]).bitwise_and_(MASK)
    x1.add_(ks[1]).bitwise_and_(MASK)
    for i in range(5):
        for r in _ROT[i % 2]:
            x0.add_(x1).bitwise_and_(MASK)
            _rotl(x1, r).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(MASK)
    return x0, x1


def _words(key: torch.Tensor) -> Tuple[int, int]:
    k = key.tolist()
    if len(k) != 2:
        raise ValueError(f"a key is 2 words, got shape {tuple(key.shape)}")
    return int(k[0]), int(k[1])


def _hash_pairs(key: torch.Tensor, lo: int, hi: int,
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both output words of the hash of counters lo..hi-1 (the
    partitionable layout: counter i is the 64-bit word pair (i >> 32,
    i & MASK))."""
    idx = torch.arange(lo, hi, dtype=torch.int64, device=device)
    x0 = torch.bitwise_right_shift(idx, 32)
    return threefry2x32(*_words(key), x0, idx.bitwise_and_(MASK))


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off (the JAX
    package's setting): the seed becomes an int32, so the key is
    ``[0, seed mod 2**32]``."""
    s = int(seed)
    if not -2**63 <= s < 2**63:
        raise OverflowError(f"seed {seed} does not fit in int64")
    return torch.tensor([0, s & MASK], dtype=torch.int64)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``."""
    d = int(data)
    if not 0 <= d <= MASK:
        raise ValueError(f"fold_in data {data} is not a uint32")
    x0, x1 = threefry2x32(*_words(key), torch.zeros(1, dtype=torch.int64),
                          torch.tensor([d], dtype=torch.int64))
    return torch.cat([x0, x1])


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (num, 2) keys."""
    b0, b1 = _hash_pairs(key, 0, int(num), torch.device("cpu"))
    return torch.stack([b0, b1], dim=1)


def _draw(key: torch.Tensor, shape: Shape, dtype: torch.dtype,
          device: Optional[torch.device], finish) -> torch.Tensor:
    """Allocate ``shape`` on ``device`` and fill it chunk by chunk with
    ``finish(bits)``, bits being the 32 random bits of a run of elements
    in row-major order."""
    shape = _shape(shape)
    device = torch.device("cpu") if device is None else torch.device(device)
    n = math.prod(shape)
    out = torch.empty(n, dtype=dtype, device=device)
    for lo in range(0, n, CHUNK):
        hi = min(lo + CHUNK, n)
        b0, b1 = _hash_pairs(key, lo, hi, device)
        out[lo:hi] = finish(b0.bitwise_xor_(b1))
        del b0, b1
    return out.reshape(shape)


def random_bits(key: torch.Tensor, shape: Shape = (),
                device: Optional[torch.device] = None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 words."""
    return _draw(key, shape, torch.int64, device, lambda b: b)


def _unit(bits: torch.Tensor) -> torch.Tensor:
    """XLA's [0, 1) float32 from 32 random bits: the top 23 bits as the
    mantissa of a number in [1, 2), minus 1."""
    m = bits.bitwise_right_shift_(9).bitwise_or_(0x3F800000)
    return m.to(torch.int32).view(torch.float32).sub_(1.0)


def _fma32(x: torch.Tensor, a: float, c: float) -> torch.Tensor:
    """float32 ``x * a + c`` rounded once, as XLA's fused multiply-add:
    the product is exact in float64, the sum is rounded to odd there
    (``TwoSum`` finds its error, an inexact even result steps one ulp
    toward it), and round-to-odd then rounds to float32 correctly."""
    p = x.double().mul_(a)
    s = p + c
    b = s - p
    err = (p - (s - b)).add_(c - b)
    bits = s.view(torch.int64)
    step = torch.where((err != 0) & (bits & 1 == 0),
                       torch.where((err > 0) == (s > 0), 1, -1), 0)
    return bits.add_(step).view(torch.float64).float()


def _uniform_from(bits: torch.Tensor, minval: float, maxval: float):
    lo = torch.tensor(minval, dtype=torch.float32)
    span = (torch.tensor(maxval, dtype=torch.float32) - lo).item()
    return _fma32(_unit(bits), span, lo.item()).clamp_min_(lo.item())


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0,
            device: Optional[torch.device] = None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    return _draw(key, shape, torch.float32, device,
                 lambda b: _uniform_from(b, minval, maxval))


def _mulmod32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2**32 for uint32 words a and a uint32 b, without
    leaving int64 (the product is split at 16 bits of b)."""
    lo = a * (b & 0xFFFF)
    hi = (a * (b >> 16)).bitwise_and_(0xFFFF).bitwise_left_shift_(16)
    return lo.add_(hi).bitwise_and_(MASK)


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int,
            device: Optional[torch.device] = None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)``: two
    32-bit draws from ``split(key)``, combined modulo the span as
    ``jax._src.random._randint`` does (in uint32 arithmetic)."""
    minval, maxval = int(minval), int(maxval)
    if not -2**31 <= minval < 2**31 or not -2**31 <= maxval < 2**31:
        raise ValueError(f"[{minval}, {maxval}) is outside int32")
    span = (maxval - minval) & MASK if maxval > minval else 1
    mult = (2**16 % span) ** 2 % 2**32 % span
    k_hi, k_lo = split(key)
    hi_bits = random_bits(k_hi, shape, device)
    lo_bits = random_bits(k_lo, shape, device)
    off = _mulmod32(hi_bits.remainder_(span), mult)
    off = off.add_(lo_bits.remainder_(span)).bitwise_and_(MASK).remainder_(span)
    return off.add_(minval).to(torch.int32)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (Giles' polynomial), op for op in
    float32; ``log1p`` is PyTorch's."""
    w = torch.log1p(x * -x).neg_()
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(small, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = p.mul_(w).add_(torch.where(small, a, b))
    return torch.where(x.abs() == 1.0, x * math.inf, p.mul_(x))


def normal(key: torch.Tensor, shape: Shape = (),
           device: Optional[torch.device] = None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``."""
    def finish(bits):
        u = _uniform_from(bits, _NEXTAFTER_M1, 1.0)
        return erf_inv(u).mul_(math.sqrt(2.0))
    return _draw(key, shape, torch.float32, device, finish)


def gumbel(key: torch.Tensor, shape: Shape = (),
           device: Optional[torch.device] = None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32, mode="low")``."""
    def finish(bits):
        u = _uniform_from(bits, _F32_TINY, 1.0)
        return u.log_().neg_().log_().neg_()
    return _draw(key, shape, torch.float32, device, finish)


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` (float32 logits,
    with replacement): argmax of logits plus Gumbel noise."""
    g = gumbel(key, tuple(logits.shape), logits.device)
    return torch.argmax(g.add_(logits.float()), dim=-1)
