"""The port's Fig-1 convnet (``repro_torch.models.convnet``) against the
JAX package's (``repro.models.convnet``).

The JAX parameters cross bitwise (``convert.from_numpy_tree``: HWIO
conv weights, the JAX layout) and both sides see the same images
(``synthetic_images`` is bitwise across packages).  Bounds held, and why:

  * logits and ``ce_loss``: within 2e-5 of the largest magnitude
    (cuDNN/oneDNN and XLA convolutions, the ghost-norm reductions and
    the loss mean sum in other orders: a few fp32 ulps each);
  * gradients (``torch.autograd`` against ``jax.grad``): within 2e-5 of
    each leaf's largest magnitude, ghost norm included.  Under ghost norm
    the conv biases ``b1``/``b2`` feed only the normalization, which
    removes any per-channel constant: their exact gradient is zero and
    both sides return rounding noise (~1e-7), so those two leaves are
    held to 2e-5 of the tree's largest gradient instead;
  * ``accuracy``: equal;
  * ``ghost_norm`` on its own: within 2e-5 of the largest magnitude, the
    not-dividing ``ValueError`` text equal;
  * ``init_convnet(seed)``: fp32 leaves within ``prng.NORMAL_ULP + 1``
    (4) ulps, zeros bitwise (the ``materialize`` bound, PERF.md §2).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.data.synthetic import synthetic_images as jax_images
from repro.models import convnet as jconv
from repro_torch import prng
from repro_torch.convert import from_numpy_tree
from repro_torch.data import synthetic_images
from repro_torch.models import convnet as tconv

REL = 2e-5
BATCH = 16


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))


def _params(width, seed=0):
    """The JAX init (numpy tree) and the same bits as the port's dict."""
    jp = jax.tree.map(np.asarray, jconv.init_convnet(seed, width=width))
    return jp, from_numpy_tree(jp)


def _batch(n=BATCH, seed=0):
    x, y = jax_images(n, seed=seed)
    tx, ty = synthetic_images(n, seed=seed)
    assert np.array_equal(x, tx.numpy()) and np.array_equal(y, ty.numpy())
    return (x, y), (tx, ty)


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(initial=0.0), 1e-30)
    err = np.abs(got - want).max(initial=0.0)
    assert err <= rel * scale, f"max abs diff {err:.3g} > {rel} x {scale:.3g}"


@pytest.mark.parametrize("width", [8, 32])
def test_defs_are_the_jax_defs(width):
    jd, td = jconv.convnet_defs(width=width), tconv.convnet_defs(width=width)
    assert list(jd) == list(td)
    for k in jd:
        assert (jd[k].shape, jd[k].init, jd[k].scale) == \
            (td[k].shape, td[k].init, td[k].scale), k


@pytest.mark.parametrize("width,seed", [(8, 0), (8, 3), (32, 0)])
def test_init_within_materialize_bound(width, seed):
    jp, _ = _params(width, seed)
    got = tconv.init_convnet(seed, device="cpu", width=width)
    assert sorted(got) == sorted(jp)
    for k, t in got.items():
        assert t.dtype == torch.float32 and t.shape == jp[k].shape, k
        assert _ulps(jp[k], t.numpy()).max(initial=0) <= prng.NORMAL_ULP + 1, k


@pytest.mark.parametrize("width,ghost", [(8, None), (8, 4), (8, 8), (32, None)])
def test_logits_loss_and_accuracy_match_jax(width, ghost):
    jp, tp = _params(width)
    (x, y), (tx, ty) = _batch()
    _close(tconv.convnet_apply(tp, tx, ghost_batch=ghost).numpy(),
           jconv.convnet_apply(jp, x, ghost_batch=ghost))
    _close(tconv.ce_loss(tp, tx, ty, ghost_batch=ghost).item(),
           jconv.ce_loss(jp, x, y, ghost_batch=ghost))
    assert float(tconv.accuracy(tp, tx, ty, ghost_batch=ghost)) == \
        float(jconv.accuracy(jp, x, y, ghost_batch=ghost))


@pytest.mark.parametrize("width,ghost", [(8, None), (8, 4), (8, 8), (32, None)])
def test_gradients_match_jax_grad(width, ghost):
    jp, tp = _params(width)
    (x, y), (tx, ty) = _batch(seed=2)
    want = jax.grad(jconv.ce_loss)(jax.tree.map(jnp.asarray, jp), x, y,
                                   ghost_batch=ghost)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tconv.ce_loss(leaves, tx, ty, ghost_batch=ghost).backward()
    tree_max = max(float(jnp.abs(g).max()) for g in want.values())
    for k, v in leaves.items():
        assert v.grad.shape == v.shape, k
        if ghost and k in ("b1", "b2"):         # exactly zero: noise only
            assert np.abs(v.grad.numpy()).max() <= REL * tree_max, k
            assert float(jnp.abs(want[k]).max()) <= REL * tree_max, k
        else:
            _close(v.grad.numpy(), want[k])


@pytest.mark.parametrize("ghost", [4, 8, 16, 64])
def test_ghost_norm_alone_matches_jax(ghost):
    h = np.random.RandomState(ghost).randn(16, 8, 8, 6).astype(np.float32) * 3 + 1
    want = jconv.ghost_norm(jnp.asarray(h), ghost)
    _close(tconv.ghost_norm(torch.from_numpy(h), ghost).numpy(), want)
    # the channel-first form convnet_apply uses is the same map
    nchw = tconv.ghost_norm(torch.from_numpy(h).permute(0, 3, 1, 2), ghost,
                            channel_dim=1)
    _close(nchw.permute(0, 2, 3, 1).numpy(), want)


def test_ghost_norm_that_does_not_divide_raises_the_jax_message():
    h = np.zeros((12, 4, 4, 2), np.float32)
    with pytest.raises(ValueError) as jerr:
        jconv.ghost_norm(jnp.asarray(h), 5)
    with pytest.raises(ValueError) as terr:
        tconv.ghost_norm(torch.from_numpy(h), 5)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="must divide the batch 12"):
        tconv.convnet_apply(tconv.init_convnet(0, device="cpu", width=8),
                            torch.zeros(12, 32, 32, 3), ghost_batch=5)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is present")
def test_init_defaults_to_the_card_and_raises_without_one():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tconv.init_convnet(0)
