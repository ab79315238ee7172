"""The split-KV order of the port's paged decode attention kernel, in
plain PyTorch, against the JAX package.

``paged_attention_split_ref`` repeats the CUDA kernel's order of work:
the table's positions cut into splits, one max and one sum per head in
each split, the live splits merged in split order.  It is held against
the JAX Pallas kernel in interpret mode (fp32 2e-5, bf16 3e-2 abs) and
against the JAX ``paged_attention_ref`` (fp32 1e-6, bf16 3e-2 of the
output's largest magnitude), the bounds of
``tests/test_torch_paged_attention.py``.  Inputs are numpy arrays from
a seed, handed to both.  The CUDA kernel itself runs only on the card
(``chip_smoke.py`` phase 2, and the ``cuda``-marked test below)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.paged_attention.kernel import paged_decode_attention
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_ref
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import (paged_attention_ref,
                                                     paged_attention_split_ref)

TOL = {"float32": dict(ref=1e-6, kernel=2e-5), "bfloat16": dict(ref=3e-2, kernel=3e-2)}
NBT = 3                                    # table columns


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _case(G, K, hd, bs, seed):
    """Five rows: frontiers at 0, on a block edge, inside a block and at
    the last slot, and an inactive row (table at scratch block 0, pos 0),
    each row on its own non-scratch blocks."""
    rng = np.random.RandomState(seed)
    B, nb = 5, 1 + 5 * NBT + 3
    q = rng.randn(B, G * K, hd).astype(np.float32)
    kp = rng.randn(nb, bs, K, hd).astype(np.float32)
    vp = rng.randn(nb, bs, K, hd).astype(np.float32)
    bt = rng.permutation(np.arange(1, nb))[:B * NBT].reshape(B, NBT).astype(np.int32)
    bt[-1] = 0
    pos = np.array([0, bs, bs + bs // 2 + 1, NBT * bs - 1, 0], np.int32)
    return q, kp, vp, bt, pos


def _both(arrays, dtype):
    jx = [jnp.asarray(a).astype(dtype) if a.dtype == np.float32 else jnp.asarray(a)
          for a in arrays]
    th = [torch.from_numpy(a).to(getattr(torch, dtype)) if a.dtype == np.float32
          else torch.from_numpy(a) for a in arrays]
    return jx, th


# (n_split, G, K, hd, bs, kw): one split, three, and more splits than the
# table has columns (down to one position a split, boundaries inside
# pool blocks; 24 splits make two merge groups); G of 1-8, a G that is
# not a power of two; window and softcap alone and together
CASES = [(1, 8, 1, 256, 16, {}), (3, 8, 1, 256, 16, {}), (7, 8, 1, 256, 16, {}),
         (3, 4, 2, 64, 4, {}), (7, 4, 2, 64, 4, dict(window=7, softcap=20.0)),
         (1, 1, 2, 128, 4, dict(window=5)), (3, 2, 4, 128, 8, dict(softcap=30.0)),
         (5, 3, 2, 64, 4, dict(window=6, softcap=10.0)), (12, 4, 2, 64, 4, {}),
         (3, 8, 2, 256, 4, dict(window=10)), (24, 2, 2, 64, 8, dict(window=20))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_split,G,K,hd,bs,kw", CASES)
def test_split_order_matches_jax_kernel_and_ref(n_split, G, K, hd, bs, kw, dtype):
    (q, kp, vp, bt, pos), th = _both(_case(G, K, hd, bs, seed=n_split + G + hd + bs),
                                     dtype)
    o = paged_attention_split_ref(*th, n_split=n_split, **kw)
    assert o.dtype == th[0].dtype and o.shape == th[0].shape
    got = o.float().numpy()
    kern = np.asarray(paged_decode_attention(q, kp, vp, bt, pos, interpret=True, **kw),
                      np.float32)
    assert np.max(np.abs(kern - got)) <= TOL[dtype]["kernel"]
    r = np.asarray(jax_ref(q, kp, vp, bt, pos, **kw), np.float32)
    assert np.max(np.abs(r - got)) / max(1.0, np.max(np.abs(r))) <= TOL[dtype]["ref"]


@pytest.mark.parametrize("T,bs,BK", [(544, 16, 8), (8192, 16, 8), (8192, 16, 128),
                                     (8192, 16, 1), (4, 4, 6), (80, 16, 160)])
def test_split_plan_covers_the_table_in_one_wave(T, bs, BK):
    """The wrapper's plan from the shapes alone: the splits cover the
    table, hold at least one pool block and 32 positions (64 from
    LONG_TABLE on) unless the table is shorter, fit the kernel's score
    buffer, and make at most one wave of blocks on 132 SMs unless B * K
    alone exceeds it or the score buffer asks for more splits."""
    split_len, n_split = ops.split_plan(T, bs, BK, 132)
    assert n_split == -(-T // split_len) and split_len * n_split >= T
    assert split_len <= ops.MAX_SPLIT_LEN
    assert split_len >= min(T, max(bs, 64 if T >= ops.LONG_TABLE else 32))
    assert n_split <= max(1, 132 // BK) or split_len == ops.MAX_SPLIT_LEN


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode "
                    "(chip_smoke.py runs it on the card)")
    for n_split, G, K, hd, bs, kw in CASES:
        arrays = _case(G, K, hd, bs, seed=11)
        q, kp, vp, bt, pos = (torch.from_numpy(a).cuda() for a in arrays)
        q, kp, vp = (t.to(getattr(torch, dtype)) for t in (q, kp, vp))
        split_len = -(-NBT * bs // n_split)
        o = ops.launch_split(q, kp, vp, bt, pos, split_len=split_len, **kw)
        again = ops.launch_split(q, kp, vp, bt, pos, split_len=split_len, **kw)
        r = paged_attention_ref(q, kp, vp, bt, pos, **kw)
        torch.cuda.synchronize()
        assert torch.equal(o, again)
        assert (o.float() - r.float()).abs().max().item() <= TOL[dtype]["kernel"]
