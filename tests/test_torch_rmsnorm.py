"""The port's RMSNorm op (``repro_torch.kernels.rmsnorm``) against the
JAX package's: ``rmsnorm_pallas`` in interpret mode and ``rmsnorm_ref``,
at the shapes of ``tests/test_kernels.py``'s RMSNorm test, and against
the port's own model function ``layers.rmsnorm``.

Bounds (those of the JAX package's own test): fp32 1e-5, bf16 2e-2
absolute; the plain version against ``layers.rmsnorm``, the same math
in the same ops, bitwise.  ``_kernel_math`` repeats the CUDA kernel's
sum of squares in its own fixed order (a warp a row, or a block a row
for wide rows) in numpy fp32 and is held against the Pallas kernel in
interpret mode within the card's bound.  The CUDA kernel against the
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

from repro.kernels.rmsnorm.kernel import rmsnorm_pallas
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref
from repro_torch.kernels import launch_counts
from repro_torch.kernels.rmsnorm import ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.models import layers

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(4, 128), (3, 7, 256), (2, 33, 300), (16, 2048)]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(shape, dtype, seed):
    r = np.random.RandomState(seed)
    x = r.randn(*shape).astype(np.float32)
    s = (1.0 + 0.1 * r.randn(shape[-1])).astype(np.float32)
    x = np.asarray(jnp.asarray(x).astype(dtype).astype(jnp.float32))
    return x, s


def _to_torch(x, dtype):
    return torch.from_numpy(x).to(TORCH_DTYPES[dtype])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_pallas_interpret_and_jax_ref(shape, dtype):
    x, s = _inputs(shape, dtype, seed=len(shape) + shape[-1])
    jx = jnp.asarray(x).astype(dtype)
    want_k = np.asarray(rmsnorm_pallas(jx, jnp.asarray(s), interpret=True), np.float32)
    want_r = np.asarray(jax_rmsnorm_ref(jx, jnp.asarray(s)), np.float32)
    before = launch_counts()["rmsnorm"]
    got = ops.rmsnorm(_to_torch(x, dtype), torch.from_numpy(s))
    assert launch_counts()["rmsnorm"] == before        # the CPU runs no kernel
    assert got.dtype == TORCH_DTYPES[dtype] and tuple(got.shape) == shape
    got = got.float().numpy()
    np.testing.assert_allclose(got, want_k, atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(got, want_r, atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_equals_the_models_rmsnorm(dtype):
    x, s = _inputs((5, 9, 300), dtype, seed=3)
    xt, st = _to_torch(x, dtype), torch.from_numpy(s)
    for eps in (1e-6, 1e-5):
        assert torch.equal(ops.rmsnorm(xt, st, eps), layers.rmsnorm(st, xt, eps))


def test_scale_in_bf16_and_eps_are_applied():
    x, s = _inputs((6, 256), "float32", seed=4)
    st = torch.from_numpy(s).to(torch.bfloat16)
    want = np.asarray(jax_rmsnorm_ref(jnp.asarray(x), jnp.asarray(s).astype(jnp.bfloat16),
                                      eps=1e-2))
    got = ops.rmsnorm(torch.from_numpy(x), st, eps=1e-2).numpy()
    np.testing.assert_allclose(got, want, atol=TOL["float32"], rtol=0)


def _lane_tree(s):
    """The warp's xor tree over the last axis (32 lanes): every lane adds
    its partner's partial at offsets 16, 8, 4, 2, 1; all end equal."""
    for off in (16, 8, 4, 2, 1):
        s = s + s[..., np.arange(32) ^ off]
    return s[..., 0]


def _kernel_math(x, scale, eps, P):
    """The CUDA kernel's arithmetic on rows of x (fp32 numpy) in loads of
    P elements (``ops.load_pack``): lane l (thread t) sums the squares of
    packs l + 32 i (t + 256 i) in order, then the warp's xor tree, then
    (a block a row) the 8 warp sums in order."""
    rows, d = x.shape
    NP = 16 if P > 1 else 32                 # at most this many packs a lane
    sq = (x * x).astype(np.float32)
    if d <= 32 * NP * P:                                 # a warp a row
        pad = np.zeros((rows, 32 * NP * P), np.float32)
        pad[:, :d] = sq
        parts = pad.reshape(rows, NP, 32, P)
        lane = np.zeros((rows, 32), np.float32)
        for i in range(NP):
            for c in range(P):
                lane = lane + parts[:, i, :, c]
        total = _lane_tree(lane)
    else:                                                # a block a row
        n = -(-d // (256 * P))
        pad = np.zeros((rows, n * 256 * P), np.float32)
        pad[:, :d] = sq
        parts = pad.reshape(rows, n, 256, P)
        thread = np.zeros((rows, 256), np.float32)
        for i in range(n):
            for c in range(P):
                thread = thread + parts[:, i, :, c]
        warps = _lane_tree(thread.reshape(rows, 8, 32))
        total = warps[:, 0]
        for w in range(1, 8):
            total = total + warps[:, w]
    inv = np.float32(1) / np.sqrt(total / np.float32(d) + np.float32(eps))
    return (x * inv[:, None]) * scale


@pytest.mark.parametrize("shape", [(16, 2048), (3, 7, 256), (2, 33, 300),
                                   (5, 4608), (3, 4100), (3, 4102)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_math_matches_pallas_interpret(shape, dtype):
    """Every path: a warp a row (2048, 256, 300) or a block a row (4608,
    4100, 4102), in loads of 16 bytes, 8 (bf16 300, 4100) or one element
    (4102); held to the card's bound, 1e-5 + (bf16) 2^-7 max(|y|, |y_ref|)."""
    x, s = _inputs(shape, dtype, seed=shape[-1] + 7)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(rmsnorm_pallas(jx, jnp.asarray(s), interpret=True), np.float32)
    xt, st = _to_torch(x, dtype), torch.from_numpy(s)
    pack = ops.load_pack(shape[-1], xt, st, xt)
    assert pack == {300: 4, 4100: 4, 4102: 1}.get(shape[-1], 16 // xt.element_size())
    got = _kernel_math(x.reshape(-1, shape[-1]), s, 1e-6, pack)
    got = np.asarray(jnp.asarray(got).astype(dtype), np.float32).reshape(shape)
    bound = TOL["float32"]
    if dtype == "bfloat16":
        bound = bound + 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want))
    assert (np.abs(got - want) / bound).max() <= 1


def test_other_devices_raise():
    x = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.rmsnorm(x, torch.empty((8,), device="meta"))


def test_ops_import_no_jax_and_nothing_of_repro():
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import repro_torch.kernels.rmsnorm.ops\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(dtype):
    """fp32 within 1e-5; bf16 within that plus one bf16 step of the value
    (2^-7 |y|): another row-sum order can round a bf16 output one step
    the other way, and a step exceeds 2e-2 from |y| = 4 up.  Every path:
    a warp or a block a row, loads of 16, 8 or 2-4 bytes, a row staged
    in shared memory or read twice (fp32 70,000; 120,002)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    for shape in SHAPES + [(8 * 512, 2048), (33 * 7, 300), (5, 4608), (3, 4100),
                           (3, 4102), (2, 70000), (2, 120002)]:
        x, s = _inputs(shape, dtype, seed=shape[-1])
        xt, st = _to_torch(x, dtype).cuda(), torch.from_numpy(s).cuda()
        before = launch_counts()["rmsnorm"]
        got = ops.rmsnorm(xt, st)
        torch.cuda.synchronize()
        assert launch_counts()["rmsnorm"] == before + 1
        got, want = got.float(), rmsnorm_ref(xt, st).float()
        bound = TOL["float32"]
        if dtype == "bfloat16":
            bound = bound + 2.0 ** -7 * torch.maximum(got.abs(), want.abs())
        excess = ((got - want).abs() / bound).max().item()
        assert excess <= 1, (shape, excess)
