"""Mamba2's SSD and its block in the port (``repro_torch.models.mamba``)
against the JAX package's ``repro.models.mamba``.

Inputs come from numpy with a seed; the block's weights are the JAX
package's ``materialize(mamba_defs(cfg), PRNGKey(0))`` for the smoke
variant of mamba2-1.3b (one layer, so every leaf is drawn at its true
fan-in), carried across by ``repro_torch.convert``.  Bounds, relative to
the largest magnitude of the reference output, and why:

  * ``ssd_chunked`` against the JAX function: 1e-5 (fp32, the same
    einsums summed in other orders); against a token-by-token torch
    recurrence (``tests/test_ssd.py``'s oracle): 1e-4, the chunked scan's
    reassociation;
  * ``_segsum``, ``_conv_full``, ``_gated_rmsnorm``: 1e-6 (fp32, a few
    ulp);
  * ``mamba_block`` in its three modes (full sequence, prefill with its
    conv and SSM state, decode steps with theirs): fp32 5e-5, bf16 5e-2,
    the model tests' bounds (bf16 rounds at other places inside the two
    frameworks' matmuls);
  * ``A_log`` (``arange_log`` init, log of a uniform draw): within one
    fp32 ulp of the JAX leaf (``torch.log`` and XLA's ``log`` may round
    the last bit apart).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfg
from repro.models import mamba as jm
from repro.models.param import ParamDef as JaxParamDef
from repro.models.param import materialize as jax_materialize
from repro_torch import configs as tcfg
from repro_torch import prng
from repro_torch.convert import from_numpy_tree
from repro_torch.models import mamba as tm
from repro_torch.models.param import ParamDef, materialize

REL = {"float32": 5e-5, "bfloat16": 5e-2}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(ref, got):
    ref = np.asarray(ref, np.float32)
    got = (got.detach().float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    return float(np.abs(ref - got).max()) / max(float(np.abs(ref).max()), 1e-30)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _ssd_inputs(S, H=4, P=8, G=1, N=16, B=2, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(B, S, H, P).astype(np.float32)
    dt = np.log1p(np.exp(r.randn(B, S, H))).astype(np.float32)     # softplus
    A = -np.exp(r.randn(H) * 0.5).astype(np.float32)
    Bm = r.randn(B, S, G, N).astype(np.float32)
    Cm = r.randn(B, S, G, N).astype(np.float32)
    return x, dt, A, Bm, Cm


def naive_ssd(x, dt, A, B_, C_):
    """Token-by-token linear recurrence (``tests/test_ssd.py``'s oracle):
    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T ;  y_t = C_t . h_t"""
    Bb, S, H, P = x.shape
    rep = H // B_.shape[2]
    Bh, Ch = B_.repeat_interleave(rep, 2), C_.repeat_interleave(rep, 2)
    h = torch.zeros((Bb, H, P, B_.shape[3]))
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t] * A)
        xdt = x[:, t] * dt[:, t][..., None]
        h = h * dA[..., None, None] + torch.einsum("bhp,bhn->bhpn", xdt, Bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    return torch.stack(ys, 1), h


SSD_GRID = [(32, 8, 1), (64, 16, 1), (48, 48, 1), (32, 8, 2)]


@pytest.mark.parametrize("S,chunk,G", SSD_GRID,
                         ids=[f"S{s}-chunk{c}-G{g}" for s, c, g in SSD_GRID])
def test_ssd_chunked_matches_jax_and_the_recurrence(S, chunk, G):
    ins = _ssd_inputs(S, G=G)
    jy, jh = jax.jit(jm.ssd_chunked, static_argnums=5)(*map(jnp.asarray, ins), chunk)
    ty, th = tm.ssd_chunked(*map(_t, ins), chunk)
    assert ty.dtype == th.dtype == torch.float32
    assert _rel(jy, ty) <= 1e-5 and _rel(jh, th) <= 1e-5
    ny, nh = naive_ssd(*map(_t, ins))
    assert _rel(ny, ty) <= 1e-4 and _rel(nh, th) <= 1e-4


def test_ssd_chunked_carries_an_initial_state_and_refuses_a_ragged_length():
    ins = _ssd_inputs(32)
    h0 = np.random.RandomState(1).randn(2, 4, 8, 16).astype(np.float32)
    jy, jh = jm.ssd_chunked(*map(jnp.asarray, ins), 8, h0=jnp.asarray(h0))
    ty, th = tm.ssd_chunked(*map(_t, ins), 8, h0=_t(h0))
    assert _rel(jy, ty) <= 1e-5 and _rel(jh, th) <= 1e-5
    with pytest.raises(ValueError, match="multiple of chunk"):
        tm.ssd_chunked(*map(_t, ins), 12)


def test_segsum_conv_and_gated_norm_match_jax():
    r = np.random.RandomState(2)
    x = r.randn(2, 3, 16).astype(np.float32)
    js, ts = np.asarray(jm._segsum(jnp.asarray(x))), tm._segsum(_t(x))
    fin = np.isfinite(js)
    assert (fin == torch.isfinite(ts).numpy()).all() and not fin.all()
    assert _rel(js[fin], ts[torch.from_numpy(fin)]) <= 1e-6
    xbc = r.randn(2, 11, 24).astype(np.float32)
    w, b = r.randn(4, 24).astype(np.float32), r.randn(24).astype(np.float32)
    assert _rel(jm._conv_full(*map(jnp.asarray, (xbc, w, b))),
                tm._conv_full(*map(_t, (xbc, w, b)))) <= 1e-6
    y, z = r.randn(2, 5, 32).astype(np.float32), 3 * r.randn(2, 5, 32).astype(np.float32)
    scale = r.rand(32).astype(np.float32)
    assert _rel(jm._gated_rmsnorm(*map(jnp.asarray, (scale, y, z)), 1e-6),
                tm._gated_rmsnorm(*map(_t, (scale, y, z)), 1e-6)) <= 1e-6


def test_segsum_masks_before_the_exp_so_gradients_stay_finite():
    """exp(segsum) masks its upper triangle with -inf before the exp: the
    decay matrix and the gradient through it are finite, no inf - inf."""
    x = torch.rand(2, 3, 16, dtype=torch.float32).requires_grad_()
    L = torch.exp(tm._segsum(-x))
    assert torch.isfinite(L).all() and (L.triu(1) == 0).all()
    (L * torch.randn_like(L)).sum().backward()
    assert torch.isfinite(x.grad).all()


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

def _block(dtype):
    jc, tc = (dataclasses.replace(mod.smoke_variant(mod.ARCHS["mamba2-1.3b"]),
                                  compute_dtype=dtype) for mod in (jcfg, tcfg))
    npp = jax.tree.map(np.asarray, jax_materialize(jm.mamba_defs(jc),
                                                   jax.random.PRNGKey(0)))
    return jc, tc, npp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_three_modes_match_jax(dtype):
    """S 20 on chunk 16 (the padded tail runs): the full-sequence output,
    the prefill's conv tail and SSM state, then 3 decode steps, each
    step's output and both states, against the JAX block."""
    jc, tc, npp = _block(dtype)
    jp, tp = jax.tree.map(jnp.asarray, npp), from_numpy_tree(npp)
    assert -(-20 // tc.ssm.chunk) * tc.ssm.chunk > 20
    x = np.random.RandomState(3).randn(2, 23, tc.d_model).astype(np.float32)
    rel = REL[dtype]
    jblk = jax.jit(lambda p, x, c: jm.mamba_block(p, x, jc, cache=c))
    jy, jcache = jblk(jp, jnp.asarray(x[:, :20]), None)
    ty, tcache = tm.mamba_block(tp, _t(x[:, :20]), tc)
    ty2, none = tm.mamba_block(tp, _t(x[:, :20]), tc, build_cache=False)
    assert none is None and torch.equal(ty, ty2)
    assert ty.dtype == getattr(torch, dtype) and _rel(jy, ty) <= rel
    assert tcache["conv"].dtype == getattr(torch, dtype)
    assert tcache["ssm"].dtype == torch.float32
    for k in ("conv", "ssm"):
        assert tuple(tcache[k].shape) == jcache[k].shape
        assert _rel(jcache[k], tcache[k]) <= rel, k
    conv, ssm = tcache["conv"], tcache["ssm"]
    for t in range(20, 23):
        jy, jcache = jblk(jp, jnp.asarray(x[:, t:t + 1]), jcache)
        ty, out = tm.mamba_block(tp, _t(x[:, t:t + 1]), tc, cache=tcache)
        assert out is tcache and out["conv"] is conv and out["ssm"] is ssm
        assert _rel(jy, ty) <= rel, t
        for k in ("conv", "ssm"):
            assert _rel(jcache[k], tcache[k]) <= rel, (t, k)


def test_mamba_block_decode_writes_views_of_a_stacked_cache():
    """Decode on views of stacked (n_periods, B, ...) leaves, as
    ``forward`` hands them over: the writes reach the stack, the other
    period's state is untouched, and the result equals decode on a
    private copy (the conv shift reads the tail before overwriting it)."""
    _, tc, npp = _block("float32")
    tp = from_numpy_tree(npp)
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 9, tc.d_model)
                         .astype(np.float32))
    _, c = tm.mamba_block(tp, x[:, :8], tc)
    stack = {k: torch.stack([v.clone(), v + 1]) for k, v in c.items()}
    before = {k: v[1].clone() for k, v in stack.items()}
    y_view, _ = tm.mamba_block(tp, x[:, 8:], tc, cache={k: v[0] for k, v in stack.items()})
    y_own, own = tm.mamba_block(tp, x[:, 8:], tc, cache=c)
    assert torch.equal(y_view, y_own)
    for k in own:
        assert torch.equal(stack[k][0], own[k]) and torch.equal(stack[k][1], before[k])


def test_short_prompt_refused_where_a_cache_is_built():
    """The departure from the reference: a prefill of fewer than
    conv_width - 1 tokens would build no decode state (the reference
    returns none, and its next decode silently restarts the recurrence);
    the port raises, naming the length and the minimum.  Train mode
    builds no cache and runs."""
    _, tc, npp = _block("float32")
    tp = from_numpy_tree(npp)
    x = torch.randn(1, 2, tc.d_model)
    with pytest.raises(ValueError, match=r"2 tokens.*conv_width - 1 = 3"):
        tm.mamba_block(tp, x, tc)
    y, c = tm.mamba_block(tp, x, tc, build_cache=False)
    assert c is None and y.shape == x.shape
    _, c = tm.mamba_block(tp, torch.randn(1, 3, tc.d_model), tc)
    assert c["conv"].shape == (1, 3, tc.ssm.expand * tc.d_model
                               + 2 * tc.ssm.ngroups * tc.ssm.d_state)


def test_a_log_init_within_one_ulp_of_jax():
    """mamba2-1.3b's stacked A_log leaf (48 x 64), drawn from the JAX
    package's key for its path: log of a uniform draw in [1, 16)."""
    shape = (48, 64)
    jtree = {"blocks": {"L0": {"mamba": {"A_log": JaxParamDef(
        shape, ("layers", "heads"), "arange_log")}}}}
    ttree = {"blocks": {"L0": {"mamba": {"A_log": ParamDef(
        shape, ("layers", "heads"), "arange_log")}}}}
    want = np.asarray(jax_materialize(jtree, jax.random.PRNGKey(0))
                      ["blocks"]["L0"]["mamba"]["A_log"])
    got = materialize(ttree, prng.PRNGKey(0), torch.device("cpu"))["blocks.L0.mamba.A_log"]
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    ulps = np.abs(want.view(np.int32).astype(np.int64)
                  - got.numpy().view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    assert 0.0 <= got.min() and got.max() < np.log(16.0)
