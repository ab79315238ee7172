"""The port's flash attention op (``repro_torch.kernels.flash_attention``)
against the JAX package's: ``flash_attention`` in interpret mode (q_blk
= kv_blk = 128) and ``attention_ref``, over the grid of
``tests/test_kernels.py``'s flash tests (causal, window, softcap,
non-causal; MHA and GQA), and against the port's own model function
``layers._sdpa_seq``.

Bounds (those of the JAX package's own tests): fp32 2e-5, bf16 3e-2
absolute.  The plain version walks the queries in chunks; chunked and
whole agree to 1e-6 (other matmul shapes sum in other orders).  The CUDA
kernel against the plain version is the ``cuda``-marked test, which
skips without a card (and this module imports JAX, which the card's
machine lacks); ``chip_smoke.py`` makes the same comparisons there,
over every build variant.
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(dtype):
    """fp32 within 2e-5; bf16 within that plus one bf16 step of the value
    (2^-7 |y|): both round fp32 results that differ by ~1e-6 to bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    for (B, S, H, K, hd) in [(2, 256, 4, 4, 64), (2, 512, 4, 2, 64),
                             (2, 256, 8, 1, 128), (1, 200, 4, 2, 128),
                             (8, 512, 8, 1, 256)]:
        q, k, v = (t.cuda() for t in _torch(_qkv(B, S, H, K, hd, dtype, seed=S), dtype))
        for kw in OPTIONS + [dict(causal=False, window=64)]:
            before = launch_counts()["flash_attention"]
            got = ops.attention(q, k, v, q_blk=64, kv_blk=64, **kw)
            torch.cuda.synchronize()
            assert launch_counts()["flash_attention"] == before + 1
            got, want = got.float(), attention_ref(q, k, v, **kw).float()
            bound = TOL["float32"]
            if dtype == "bfloat16":
                bound = bound + 2.0 ** -7 * torch.maximum(got.abs(), want.abs())
            excess = ((got - want).abs() / bound).max().item()
            assert excess <= 1, ((B, S, H, K, hd), kw, excess)
