"""Paged decode attention in the PyTorch port against the JAX package.

The port's plain version (``repro_torch...paged_attention.ref``, which
its wrapper runs for CPU tensors) is held against the JAX
``paged_attention_ref`` (fp32 1e-6 of the output's largest magnitude:
the two frameworks sum the einsums in other orders; bf16 3e-2) and
against the JAX Pallas kernel in interpret mode (fp32 2e-5, bf16 3e-2:
the kernel's online softmax reassociates the sum).  Inputs are numpy arrays from a
seed, handed to both.  The CUDA kernel itself runs only on the card
(``chip_smoke.py``, and the ``cuda``-marked test below)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.paged_attention.kernel import paged_decode_attention
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_ref
from repro.models import layers as jax_layers
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.models import layers

TOL = {"float32": dict(ref=1e-6, kernel=2e-5), "bfloat16": dict(ref=3e-2, kernel=3e-2)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _case(B, H, K, hd, bs, nbt, seed):
    """Random pools, a block table of distinct non-scratch blocks, and
    frontiers at 0, on a block boundary, inside a partial last block and
    at the very last slot; the last row is inactive (table at scratch
    block 0, pos 0), as the scheduler parks a free slot."""
    rng = np.random.RandomState(seed)
    nb = 1 + B * nbt + 3
    q = rng.randn(B, H, hd).astype(np.float32)
    kp = rng.randn(nb, bs, K, hd).astype(np.float32)
    vp = rng.randn(nb, bs, K, hd).astype(np.float32)
    bt = rng.permutation(np.arange(1, nb))[:B * nbt].reshape(B, nbt)
    bt = bt.astype(np.int32)
    bt[-1] = 0
    pos = np.array([0, bs, bs + bs // 2 + 1, nbt * bs - 1, 0][:B], np.int32)
    return q, kp, vp, bt, pos


def _both(arrays, dtype):
    jx = [jnp.asarray(a).astype(dtype) if a.dtype == np.float32 else jnp.asarray(a)
          for a in arrays]
    th = [torch.from_numpy(a).to(getattr(torch, dtype)) if a.dtype == np.float32
          else torch.from_numpy(a) for a in arrays]
    return jx, th


def _err(jax_out, torch_out, relative=False):
    r = np.asarray(jax_out, np.float32)
    err = np.max(np.abs(r - torch_out.float().numpy()))
    return err / max(1.0, np.max(np.abs(r))) if relative else err


# (G, K, hd, bs): every G in {1, 4, 8}, K in {1, 2}, hd in {64, 128, 256}
# and bs in {4, 16} appears; (8, 1, 256, 16) is gemma-2b's decode shape
GRID = [(1, 1, 64, 4), (4, 1, 128, 16), (8, 1, 256, 16), (1, 2, 128, 4),
        (4, 2, 64, 16), (8, 2, 256, 4)]
EXTRAS = [dict(window=10), dict(softcap=30.0), dict(window=7, softcap=20.0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,K,hd,bs", GRID)
def test_plain_matches_jax_ref(G, K, hd, bs, dtype):
    (q, kp, vp, bt, pos), (tq, tkp, tvp, tbt, tpos) = _both(
        _case(5, G * K, K, hd, bs, 3, seed=G + 10 * K + hd + bs), dtype)
    r = jax_ref(q, kp, vp, bt, pos)
    o = paged_attention_ref(tq, tkp, tvp, tbt, tpos)
    assert o.dtype == tq.dtype and o.shape == tq.shape
    assert _err(r, o, relative=True) <= TOL[dtype]["ref"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", EXTRAS, ids=["window", "softcap", "window+softcap"])
def test_plain_window_softcap_matches_jax_ref(kw, dtype):
    (q, kp, vp, bt, pos), (tq, tkp, tvp, tbt, tpos) = _both(
        _case(5, 8, 2, 64, 8, 4, seed=3), dtype)
    r = jax_ref(q, kp, vp, bt, pos, **kw)
    o = paged_attention_ref(tq, tkp, tvp, tbt, tpos, **kw)
    assert _err(r, o, relative=True) <= TOL[dtype]["ref"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,K,hd,bs,kw", [
    (8, 1, 256, 16, {}), (4, 2, 64, 4, {}), (1, 2, 128, 16, {}),
    (4, 2, 64, 8, dict(window=7, softcap=20.0))])
def test_plain_matches_jax_interpret_kernel(G, K, hd, bs, kw, dtype):
    (q, kp, vp, bt, pos), (tq, tkp, tvp, tbt, tpos) = _both(
        _case(5, G * K, K, hd, bs, 3, seed=7 + hd), dtype)
    r = paged_decode_attention(q, kp, vp, bt, pos, interpret=True, **kw)
    o = paged_attention_ref(tq, tkp, tvp, tbt, tpos, **kw)
    assert _err(r, o) <= TOL[dtype]["kernel"]


def test_wrapper_on_cpu_runs_plain_version_without_launching():
    q, kp, vp, bt, pos = (torch.from_numpy(a) for a in _case(4, 8, 2, 64, 4, 3, 1))
    before = dict(LAUNCHES)
    o = ops.paged_attention(q, kp, vp, bt, pos, window=5, softcap=10.0)
    torch.testing.assert_close(
        o, paged_attention_ref(q, kp, vp, bt, pos, window=5, softcap=10.0),
        rtol=0, atol=0)
    assert LAUNCHES == before


@pytest.mark.parametrize("bad", ["hd", "group", "dtype", "bt_dtype", "pos_shape",
                                 "head_stride"])
def test_wrapper_checks_reject_what_the_kernel_does_not_take(bad):
    q, kp, vp, bt, pos = (torch.from_numpy(a) for a in _case(4, 8, 2, 64, 4, 3, 2))
    if bad == "hd":
        q, kp, vp = q[..., :48].contiguous(), kp[..., :48], vp[..., :48]
    elif bad == "group":
        q = torch.cat([q, q, q, q], dim=1)                # H 32, K 2: G 16
    elif bad == "dtype":
        kp = kp.to(torch.bfloat16)
    elif bad == "bt_dtype":
        bt = bt.long()
    elif bad == "pos_shape":
        pos = pos[:2]
    elif bad == "head_stride":
        kp = kp.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises((ValueError, TypeError)):
        ops._check(q, kp, vp, bt, pos)


def test_plain_matches_port_model_gather_path():
    """The plain version equals the port's model-level gather path
    (``_paged_gather`` + ``_sdpa``), as the JAX package's ref equals its
    own (fp32, reassociation only)."""
    q, kp, vp, bt, pos = (torch.from_numpy(a) for a in _case(4, 8, 2, 64, 8, 3, 5))
    r = paged_attention_ref(q, kp, vp, bt, pos)
    kd, vd = layers._paged_gather(kp, bt), layers._paged_gather(vp, bt)
    valid = layers._paged_valid(pos, kd.shape[1], 0)
    mask = torch.where(valid, 0.0, layers.NEG_INF).float()[:, None, None, :]
    o = layers._sdpa(q[:, None], kd, vd, mask, 0.0, 64 ** -0.5)[:, 0]
    torch.testing.assert_close(o, r, rtol=0, atol=2e-6)
    # and the gather/valid helpers equal the JAX package's bitwise
    np.testing.assert_array_equal(
        kd.numpy(), np.asarray(jax_layers._paged_gather(jnp.asarray(kp.numpy()),
                                                        jnp.asarray(bt.numpy()))))
    np.testing.assert_array_equal(
        layers._paged_valid(pos, 24, 5).numpy(),
        np.asarray(jax_layers._paged_valid(jnp.asarray(pos.numpy()), 24, 5)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_hands_the_kernel_what_it_takes(monkeypatch, dtype):
    """Every call the paged decode path makes passes the CUDA wrapper's
    checks (shapes, dtypes, contiguity, strides, alignment), so the
    kernel takes on the card what the plain version takes here."""
    import dataclasses
    from repro_torch.configs import ARCHS, smoke_variant
    from repro_torch.launch import serve as launcher
    from repro_torch.models import CPU_RUNTIME
    calls = []

    def checked(q, kp, vp, bt, pos, **kw):
        ops._check(q, kp, vp, bt, pos)
        calls.append((q.shape, kp.shape, kw))
        return paged_attention_ref(q, kp, vp, bt, pos, **kw)
    monkeypatch.setattr(layers, "paged_attention", checked)
    for arch in ("gemma-2b", "gemma2-27b"):
        cfg = dataclasses.replace(smoke_variant(ARCHS[arch]), compute_dtype=dtype)
        params, _ = launcher.load_model(cfg, CPU_RUNTIME, seed=0)
        sched = launcher.build_scheduler(cfg, params, CPU_RUNTIME, slots=3,
                                         block_size=4, blocks=0, ctx=20,
                                         decode_chunk=2)
        prompts = [np.arange(n, dtype=np.int32) for n in (5, 9, 3, 7)]
        launcher.serve(sched, prompts, max_new=6)
        n_layers = cfg.n_layers
        assert len(calls) == n_layers * sched.stats["decode_steps"]
        calls.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode "
                    "(chip_smoke.py runs it on the card)")
    tol = TOL[dtype]["kernel"]
    for G, K, hd, bs in GRID:
        arrays = _case(5, G * K, K, hd, bs, 3, seed=11)
        q, kp, vp, bt, pos = (torch.from_numpy(a).cuda() for a in arrays)
        q, kp, vp = (t.to(getattr(torch, dtype)) for t in (q, kp, vp))
        for kw in [{}] + EXTRAS:
            o = ops.paged_attention(q, kp, vp, bt, pos, **kw)
            r = paged_attention_ref(q, kp, vp, bt, pos, **kw)
            torch.cuda.synchronize()
            assert (o.float() - r.float()).abs().max().item() <= tol
