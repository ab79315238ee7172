"""The port's flash attention op (``repro_torch.kernels.flash_attention``)
against the JAX package's: ``flash_attention`` in interpret mode (q_blk
= kv_blk = 128) and ``attention_ref``, over the grid of
``tests/test_kernels.py``'s flash tests (causal, window, softcap,
non-causal; MHA and GQA), and against the port's own model function
``layers._sdpa_seq``.

Bounds (those of the JAX package's own tests): fp32 2e-5, bf16 3e-2
absolute.  The plain version walks the queries in chunks; chunked and
whole agree to 1e-6 (other matmul shapes sum in other orders).

The bf16 CUDA kernel computes on the tensor cores; ``_bf16_kernel_math``
below repeats its arithmetic in plain PyTorch (exact bf16 products
summed in fp32, the scale applied to the fp32 score, an online softmax
over the kernel's key tiles, P split into two bf16 terms) and holds it
against the Pallas kernel in interpret mode within the card's bf16
bound, 2e-5 + 2^-7 max(|y|, |y_ref|), before the card does.  The fp32
CUDA kernel computes on the tensor cores too, in 3xTF32;
``_fp32_kernel_math`` repeats its arithmetic (the TF32 split on the
fp32 bits, three products a k-step of 8, the online softmax over its
key tiles) and holds it against the Pallas kernel within the fp32
bound, 2e-5, which one TF32 product misses.  (Both kernels' exp is the
SFU's 2^x, within ~1e-6 of exp where p matters.)  The CUDA kernel against the
plain version is the ``cuda``-marked test, which skips without a card
(and this module imports JAX, which the card's machine lacks);
``chip_smoke.py`` makes the same comparisons there, over every build
variant.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.flash_attention.kernel import flash_attention
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models import layers as jax_layers
from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import layers

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
OPTIONS = [dict(causal=True), dict(causal=True, window=128),
           dict(causal=True, softcap=50.0), dict(causal=False)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _qkv(B, S, H, K, hd, dtype="float32", seed=0):
    r = np.random.RandomState(seed)
    out = []
    for heads in (H, K, K):
        a = r.randn(B, S, heads, hd).astype(np.float32)
        out.append(np.asarray(jnp.asarray(a).astype(dtype).astype(jnp.float32)))
    return out


def _torch(arrays, dtype="float32"):
    return [torch.from_numpy(a).to(TORCH_DTYPES[dtype]) for a in arrays]


@pytest.mark.parametrize("S,H,K,hd", [(256, 4, 4, 64), (512, 4, 2, 64),
                                      (256, 8, 1, 128)])
@pytest.mark.parametrize("kw", OPTIONS)
def test_plain_version_matches_pallas_interpret_and_jax_ref(S, H, K, hd, kw):
    arrays = _qkv(2, S, H, K, hd, seed=S + H + K)
    want_k = np.asarray(flash_attention(*map(jnp.asarray, arrays), q_blk=128,
                                        kv_blk=128, interpret=True, **kw))
    want_r = np.asarray(jax_attention_ref(*map(jnp.asarray, arrays), **kw))
    before = launch_counts()["flash_attention"]
    got = ops.attention(*_torch(arrays), q_blk=128, kv_blk=128, **kw)
    assert launch_counts()["flash_attention"] == before    # the CPU runs no kernel
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, S, H, hd)
    np.testing.assert_allclose(got.numpy(), want_k, atol=TOL["float32"], rtol=0)
    np.testing.assert_allclose(got.numpy(), want_r, atol=TOL["float32"], rtol=0)


def test_plain_version_bf16_matches_pallas_interpret_and_jax_ref():
    arrays = _qkv(1, 256, 2, 2, 64, "bfloat16", seed=12)
    jx = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]
    want_k = np.asarray(flash_attention(*jx, q_blk=128, kv_blk=128,
                                        interpret=True), np.float32)
    want_r = np.asarray(jax_attention_ref(*jx), np.float32)
    got = ops.attention(*_torch(arrays, "bfloat16"))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want_k, atol=TOL["bfloat16"], rtol=0)
    np.testing.assert_allclose(got.float().numpy(), want_r, atol=TOL["bfloat16"], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_the_models_sdpa(dtype):
    """As tests/test_kernels.py holds the Pallas kernel against the JAX
    model's ``_sdpa_seq``: window and softcap together, GQA."""
    arrays = _qkv(1, 256, 4, 2, 64, dtype, seed=15)
    q, k, v = _torch(arrays, dtype)
    got = ops.attention(q, k, v, window=64, softcap=30.0)
    port_model = layers._sdpa_seq(q, k, v, True, 64, 30.0, 64 ** -0.5)
    assert got.dtype == port_model.dtype
    np.testing.assert_allclose(got.float().numpy(), port_model.float().numpy(),
                               atol=TOL[dtype], rtol=0)
    if dtype == "float32":
        jax_model = np.asarray(jax_layers._sdpa_seq(
            *map(jnp.asarray, arrays), True, 64, 30.0, 64 ** -0.5))
        np.testing.assert_allclose(got.numpy(), jax_model, atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("kw", OPTIONS + [dict(causal=False, window=40)])
def test_chunked_plain_version_equals_one_chunk(kw):
    q, k, v = _torch(_qkv(1, 200, 4, 1, 64, seed=3))
    whole = attention_ref(q, k, v, **kw)
    chunked = attention_ref(q, k, v, q_chunk=48, **kw)
    assert (whole - chunked).abs().max().item() <= 1e-6


def test_other_devices_raise():
    q = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.attention(q, q, q)


def test_ops_import_no_jax_and_nothing_of_repro():
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import repro_torch.kernels.flash_attention.ops\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _bf16_kernel_math(q, k, v, *, causal=True, window=0, softcap=0.0,
                      split_p=True):
    """The bf16 kernel's arithmetic in plain PyTorch, fp32 output (the
    kernel rounds it to bf16).  q (B, S, H, hd), k/v (B, S, K, hd) bf16."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    bk = ops.TILES[torch.bfloat16][hd][1]
    scale = hd ** -0.5
    qf = q.float().permute(0, 2, 1, 3)                      # (B, H, S, hd)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(H // K, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(H // K, dim=1)
    s = (qf @ kf.transpose(-1, -2)) * scale                 # exact products
    if hd != 128:
        # a power of two commutes with every rounding: the same scores as
        # q * scale (exact in bf16) folded in before the product
        qs = (qf * scale).to(torch.bfloat16).float()
        assert torch.equal(qs, qf * scale)
        assert torch.equal(s, qs @ kf.transpose(-1, -2))
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    i = torch.arange(S)[:, None]
    j = torch.arange(S)[None, :]
    ok = j < S
    if causal:
        ok = ok & (j <= i)
    if window > 0:
        ok = ok & (j > i - window)
    s = torch.where(ok, s, -2.0e38)
    m = torch.full((B, H, S, 1), -2.0e38)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, hd))
    for k0 in range(0, S, bk):
        st = s[..., k0:k0 + bk]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        p_hi = p.to(torch.bfloat16).float()
        vt = vf[:, :, k0:k0 + bk]
        acc = alpha * acc + p_hi @ vt
        if split_p:
            acc = acc + (p - p_hi).to(torch.bfloat16).float() @ vt
        m = m_new
    return (acc / l.clamp_min(1e-30)).permute(0, 2, 1, 3)


BF16_OPTIONS = OPTIONS + [dict(causal=True, window=40, softcap=30.0),
                          dict(causal=False, window=40)]


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("kw", BF16_OPTIONS)
def test_bf16_kernel_math_matches_pallas_interpret(hd, kw):
    """At S 192 the key tiles are ragged (64: 3 tiles; 128 at hd 64: a
    full and a half one); q is scaled so the scores reach the softcap."""
    S = 192
    arrays = _qkv(1, S, 4, 2, hd, "bfloat16", seed=hd + len(kw))
    arrays[0] = np.asarray(jnp.asarray(arrays[0] * 2.0).astype(jnp.bfloat16)
                           .astype(jnp.float32))
    jx = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]
    want = np.asarray(flash_attention(*jx, q_blk=64, kv_blk=64, interpret=True,
                                      **kw), np.float32)
    got = _bf16_kernel_math(*_torch(arrays, "bfloat16"), **kw)
    got = got.to(torch.bfloat16).float().numpy()
    bound = TOL["float32"] + 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want))
    assert (np.abs(got - want) / bound).max() <= 1


@pytest.mark.parametrize("hd", [128, 256])
def test_bf16_kernel_math_needs_the_split_p(hd):
    """Before the output's rounding the split P holds the fp32 bound
    (2e-5) against the plain version on the same bf16 inputs; P rounded
    once to bf16 does not, which is why the kernel multiplies twice."""
    arrays = _qkv(1, 256, 4, 2, hd, "bfloat16", seed=21)
    q, k, v = _torch(arrays, "bfloat16")
    want = attention_ref(q.float(), k.float(), v.float(), window=200)
    split = _bf16_kernel_math(q, k, v, window=200)
    once = _bf16_kernel_math(q, k, v, window=200, split_p=False)
    assert (split - want).abs().max().item() <= TOL["float32"]
    assert (once - want).abs().max().item() > TOL["float32"]


def _tf32(x):
    """``cvt.rna.tf32.f32`` on the fp32 bits: add half a unit of the 13
    dropped bits to the magnitude, then clear them (round to nearest,
    ties away from zero)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mma_steps(a, b, acc, three=True, group=4):
    """acc + a @ b as the fp32 kernel's MMAs run it: k-steps of 8, each
    operand split into hi = tf32(x) and lo = tf32(x - hi), lo.hi, hi.lo,
    then hi.hi (hi.hi alone: one TF32 product) summed from zero over a
    group of k-steps (four in Q K^T: ``kKG`` in the kernel), and each
    group's sum added to the running fp32 sum."""
    for d0 in range(0, a.shape[-1], 8 * group):
        part = 0.0
        for d in range(d0, d0 + 8 * group, 8):
            a8, b8 = a[..., d:d + 8], b[..., d:d + 8, :]
            ah, bh = _tf32(a8), _tf32(b8)
            if three:
                part = part + _tf32(a8 - ah) @ bh
                part = part + ah @ _tf32(b8 - bh)
            part = part + ah @ bh
        acc = acc + part
    return acc


def _fp32_kernel_math(q, k, v, *, causal=True, window=0, softcap=0.0,
                      three=True):
    """The fp32 kernel's arithmetic in plain PyTorch: q * scale rounded
    to fp32, both products in 3xTF32 by k-steps of 8 (the order of the 8
    keys or columns inside a step is the MMA's, and its truncating sum is
    not repeated), at hd 256 the scores as the sum of two halves of the
    head dim, s / softcap as s times 1 / softcap, the online softmax over
    the kernel's key tiles, each tile's P V summed from zero before it is
    added to O.  q (B, S, H, hd), k/v (B, S, K, hd) fp32."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    bk = ops.TILES[torch.float32][hd][1]
    qs = q.permute(0, 2, 1, 3) * hd ** -0.5                 # (B, H, S, hd)
    kf = k.permute(0, 2, 1, 3).repeat_interleave(H // K, dim=1)
    vf = v.permute(0, 2, 1, 3).repeat_interleave(H // K, dim=1)
    kt = kf.transpose(-1, -2)
    w = hd // ops.FP32_HEAD_SPLIT[hd]                       # columns a warpgroup
    s = None
    for d in range(0, hd, w):
        half = _mma_steps(qs[..., d:d + w], kt[..., d:d + w, :],
                          torch.zeros((B, H, S, S)), three)
        s = half if s is None else s + half
    if softcap > 0:
        inv_cap = torch.tensor(1.0 / softcap, dtype=torch.float32)
        s = softcap * torch.tanh(s * inv_cap)
    i = torch.arange(S)[:, None]
    j = torch.arange(S)[None, :]
    ok = j < S
    if causal:
        ok = ok & (j <= i)
    if window > 0:
        ok = ok & (j > i - window)
    s = torch.where(ok, s, -2.0e38)
    m = torch.full((B, H, S, 1), -2.0e38)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, hd))
    for k0 in range(0, S, bk):
        st = s[..., k0:k0 + bk]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = _mma_steps(p, vf[:, :, k0:k0 + bk], alpha * acc, three, group=bk // 8)
        m = m_new
    return (acc / l.clamp_min(1e-30)).permute(0, 2, 1, 3)


def test_tf32_split_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -23, 0.0])
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, -(1.0 + 2.0 ** -10),
                         1.0, 0.0])
    assert torch.equal(_tf32(x), want)
    r = torch.from_numpy(np.random.RandomState(4).randn(4096).astype(np.float32))
    hi = _tf32(r)
    lo = _tf32(r - hi)
    assert ((hi.view(torch.int32) | lo.view(torch.int32)) & 0x1FFF).eq(0).all()
    assert ((hi + lo - r).abs() <= 2.0 ** -21 * r.abs()).all()


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("pair", [0, 1, 2])
def test_fp32_kernel_math_matches_pallas_interpret(hd, pair):
    """Two of BF16_OPTIONS a case.  At S 192 the kernel's key tiles are
    three (64 keys, hd 64) or six (32); q is scaled so the scores reach
    the softcap."""
    S = 192
    for kw in BF16_OPTIONS[2 * pair:2 * pair + 2]:
        arrays = _qkv(1, S, 4, 2, hd, seed=hd + len(kw))
        arrays[0] = arrays[0] * 2.0
        want = np.asarray(flash_attention(*map(jnp.asarray, arrays), q_blk=64,
                                          kv_blk=64, interpret=True, **kw))
        got = _fp32_kernel_math(*_torch(arrays), **kw).numpy()
        err = np.abs(got - want).max()
        assert err <= TOL["float32"], (kw, err)


@pytest.mark.parametrize("hd", [128, 256])
def test_fp32_kernel_math_needs_three_tf32_products(hd):
    """3xTF32 holds the fp32 bound (2e-5) against the plain version; one
    TF32 product (operands rounded once to TF32) does not, which is why
    the kernel multiplies three times."""
    q, k, v = _torch(_qkv(1, 256, 4, 2, hd, seed=22))
    want = attention_ref(q, k, v, window=200)
    three = _fp32_kernel_math(q, k, v, window=200)
    once = _fp32_kernel_math(q, k, v, window=200, three=False)
    assert (three - want).abs().max().item() <= TOL["float32"]
    assert (once - want).abs().max().item() > TOL["float32"]


def test_tiles_fit_shared_memory_and_others_raise():
    """Each (dtype, hd) tile pair fits a Hopper block's 232,448 bytes of
    shared memory as the launcher sizes it; fp32 holds the hi and lo
    parts of Q (raw at hd 256), of a K tile and of V^T, and raw V
    (231,936 bytes at hd 256, where a 64-key tile does not fit); bf16
    takes 128 queries (two warpgroups of 64); any other pair raises
    before a launch."""
    assert ops.SMEM_LIMIT == 232448
    for dtype, by_hd in ops.TILES.items():
        assert set(by_hd) == set(ops.HEAD_DIMS)
        for hd, (q_blk, kv_blk) in by_hd.items():
            assert ops.smem_bytes(dtype, hd, q_blk, kv_blk) <= ops.SMEM_LIMIT
    assert ops.smem_bytes(torch.float32, 256, 64, 32) == 231936
    assert ops.smem_bytes(torch.float32, 128, 128, 32) == 214528
    assert ops.smem_bytes(torch.float32, 256, 64, 64) > ops.SMEM_LIMIT
    assert ops.smem_bytes(torch.bfloat16, 256, 128, 64) == 196608 + 32 + 1024
    assert {t[0] for t in ops.TILES[torch.bfloat16].values()} == {128}
    assert ops.smem_bytes(torch.bfloat16, 256, 128, 128) > ops.SMEM_LIMIT
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros((1, 8, 2, 128), dtype=dtype)
        assert ops._check(q, q, q, 0, None, None) == ops.TILES[dtype][128]
        with pytest.raises(ValueError, match="takes"):
            ops._check(q, q, q, 0, 32, None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(dtype):
    """fp32 within 2e-5; bf16 within that plus one bf16 step of the value
    (2^-7 |y|): both round fp32 results that differ by ~1e-6 to bf16.
    Every dtype's tiles, hd 64/128/256, ragged S, each mask option."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    for (B, S, H, K, hd) in [(2, 256, 4, 4, 64), (2, 512, 4, 2, 64),
                             (2, 256, 8, 1, 128), (1, 200, 4, 2, 128),
                             (8, 512, 8, 1, 256)]:
        q, k, v = (t.cuda() for t in _torch(_qkv(B, S, H, K, hd, dtype, seed=S), dtype))
        for kw in OPTIONS + [dict(causal=False, window=64)]:
            before = launch_counts()["flash_attention"]
            got = ops.attention(q, k, v, **kw)            # TILES' pair
            torch.cuda.synchronize()
            assert launch_counts()["flash_attention"] == before + 1
            got, want = got.float(), attention_ref(q, k, v, **kw).float()
            bound = TOL["float32"]
            if dtype == "bfloat16":
                bound = bound + 2.0 ** -7 * torch.maximum(got.abs(), want.abs())
            excess = ((got - want).abs() / bound).max().item()
            assert excess <= 1, ((B, S, H, K, hd), kw, excess)
