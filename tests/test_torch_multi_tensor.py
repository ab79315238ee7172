"""The port's multi-tensor optimizer engine against the JAX package.

Inputs are numpy arrays drawn from a seed and handed to both sides.
Bounds held, and why:

  * plain kernels vs the JAX package's jnp oracles
    (``repro.kernels.multi_tensor.ref``): ``p`` and ``u`` bitwise (both
    sides round every elementwise op once, in the same order); the row
    sums of squares within 1e-6 relative (XLA's ``jnp.sum`` adds a row
    in another order than the port's pairwise halving; a few ulp);
  * plain kernels vs the Pallas kernels in interpret mode: fp32 within
    2e-6 of the largest magnitude (XLA contracts ``beta*u + a*ge`` into
    one FMA inside the jitted kernel body, 1 ulp); bf16 within 1e-2
    (XLA also keeps ``g + wd*p`` in fp32 where the oracle rounds it to
    bf16: a bf16-level difference);
  * layout, flatten and unflatten vs the JAX package: the same offsets
    and leaf order, bitwise round trips;
  * optimizer steps vs the JAX package's plain path (``fused=None``,
    ``_jnp_kind_step``) over 3 steps: parameters and momentum within
    2e-6 (fp32) / 2e-2 (bf16 parameters) of each leaf's largest
    magnitude, stats within 1e-6 relative.  The per-leaf norms differ by
    a few ulp (the row sum above) and SNGM divides by them;
  * the port's ``fused="multi_tensor"`` vs its own ``fused=None``:
    bitwise, every kind, fp32 and bf16;
  * ``fused_update(apply=False)``, the deferred apply of a trailing
    clip: the f32 direction and u bitwise the JAX oracle's, p untouched,
    row sums 1e-6 relative; against Pallas interpret as for apply;
  * on the card (``cuda`` marker): each CUDA kernel vs its plain
    version, bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import ml_dtypes

from repro.core import optim as jopt
from repro.core import multi_tensor as jmt
from repro.core.schedules import poly_power as jpoly
from repro.kernels.multi_tensor import ops as jops
from repro.kernels.multi_tensor import ref as jref
from repro_torch.convert import (array_to_tensor, from_numpy_tree,
                                 tensor_to_array)
from repro_torch.core import multi_tensor as tmt
from repro_torch.core import optim as topt
from repro_torch.core.schedules import poly_power as tpoly
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.kernels.multi_tensor import ops, ref

N = 2 * ref.TILE
DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
INTERPRET_REL = {"float32": 2e-6, "bfloat16": 1e-2}
STEP_REL = {"float32": 2e-6, "bfloat16": 2e-2}
# (builder, kwargs): the four engine kinds, and nesterov on the two
# builders that take it
KINDS = [("sngm", {}), ("sngm", {"norm_mode": "per_tensor"}), ("msgd", {}),
         ("lars", {}), ("sngm", {"nesterov": True}), ("msgd", {"nesterov": True})]
KIND_IDS = ["sngm", "sngm_per_tensor", "msgd", "lars", "sngm_nesterov",
            "msgd_nesterov"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat_inputs(dtype, seed=0, n=N):
    r = np.random.RandomState(seed)
    dt = DTYPES[dtype]
    p = np.asarray(r.randn(n), np.float32).astype(dt)
    g = np.asarray(r.randn(n), np.float32).astype(dt)
    u = np.asarray(r.randn(n), np.float32)
    a = np.asarray(r.rand(n // ref.CHUNK) + 0.5, np.float32)
    return p, g, u, a


def _f32(x):
    if isinstance(x, torch.Tensor):
        x = tensor_to_array(x)
    return np.asarray(x).astype(np.float32)


def _rel(ref_, got):
    ref_, got = _f32(ref_), _f32(got)
    scale = max(float(np.abs(ref_).max()), 1e-30) if ref_.size else 1.0
    return float(np.abs(ref_ - got).max()) / scale if ref_.size else 0.0


def _bitwise(a, b):
    a, b = _f32(a), _f32(b)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


# ---------------------------------------------------------------------------
# the plain kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wd", [0.0, 1e-4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_chunk_sumsq_matches_jax(dtype, wd):
    p, g, _, _ = _flat_inputs(dtype)
    got = ops.chunk_sumsq(array_to_tensor(g), array_to_tensor(p), wd=wd)
    assert got.dtype == torch.float32 and got.shape == (N // ref.CHUNK,)
    want = jref.chunk_sumsq_ref(jnp.asarray(g), jnp.asarray(p), wd=wd)
    assert _rel(want, got) <= 1e-6
    interp = jops.chunk_sumsq(jnp.asarray(g), jnp.asarray(p), wd=wd)
    assert _rel(interp, got) <= INTERPRET_REL[dtype]
    raw = ops.chunk_sumsq(array_to_tensor(g))
    assert _rel(jref.chunk_sumsq_ref(jnp.asarray(g)), raw) <= 1e-6


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("cast_g_first", [False, True])
@pytest.mark.parametrize("wd", [0.0, 1e-4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_fused_update_matches_jax(dtype, wd, cast_g_first, nesterov):
    p, g, u, a = _flat_inputs(dtype, seed=1)
    kw = dict(beta=0.9, wd=wd, cast_g_first=cast_g_first, nesterov=nesterov)
    tp, tu = array_to_tensor(p).clone(), torch.from_numpy(u.copy())
    usq = ops.fused_update(tp, array_to_tensor(g), tu, torch.from_numpy(a),
                           torch.tensor(0.37), **kw)
    assert tp.dtype == TORCH_DTYPES[dtype] and tu.dtype == torch.float32
    rp, ru, rq = jref.fused_update_ref(jnp.asarray(p), jnp.asarray(g),
                                       jnp.asarray(u), jnp.asarray(a),
                                       jnp.float32(0.37), **kw)
    assert _bitwise(rp, tp) and _bitwise(ru, tu)
    assert _rel(rq, usq) <= 1e-6
    ip, iu, iq = jops.fused_update(jnp.asarray(p), jnp.asarray(g),
                                   jnp.asarray(u), jnp.asarray(a),
                                   jnp.float32(0.37), **kw)
    for want, got in ((ip, tp), (iu, tu), (iq, usq)):
        assert _rel(want, got) <= INTERPRET_REL[dtype]


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("cast_g_first", [False, True])
@pytest.mark.parametrize("wd", [0.0, 1e-4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_fused_update_deferred_matches_jax(dtype, wd, cast_g_first,
                                                 nesterov):
    """``apply=False`` (a trailing clip's pass 2): the f32 direction and
    u bitwise the JAX oracle's, p untouched, row sums as for apply."""
    p, g, u, a = _flat_inputs(dtype, seed=6)
    kw = dict(beta=0.9, wd=wd, cast_g_first=cast_g_first, nesterov=nesterov)
    tp, tu = array_to_tensor(p).clone(), torch.from_numpy(u.copy())
    out, usq = ops.fused_update(tp, array_to_tensor(g), tu, torch.from_numpy(a),
                                torch.tensor(0.37), apply=False, **kw)
    assert out.dtype == torch.float32 and out.shape == (N,)
    assert _bitwise(p, tp) and tp.dtype == TORCH_DTYPES[dtype]
    ro, ru, rq = jref.fused_update_ref(jnp.asarray(p), jnp.asarray(g),
                                       jnp.asarray(u), jnp.asarray(a),
                                       jnp.float32(0.37), apply=False, **kw)
    assert _bitwise(ro, out) and _bitwise(ru, tu)
    assert _rel(rq, usq) <= 1e-6
    io, iu, iq = jops.fused_update(jnp.asarray(p), jnp.asarray(g),
                                   jnp.asarray(u), jnp.asarray(a),
                                   jnp.float32(0.37), apply=False, **kw)
    for want, got in ((io, out), (iu, tu), (iq, usq)):
        assert _rel(want, got) <= INTERPRET_REL[dtype]


@pytest.mark.parametrize("apply", [True, False])
def test_plain_passes_take_f32_updates_beside_bf16_params(apply):
    """A chain stage before the engine may promote a bf16 bucket's updates
    to f32 (the JAX kernels take them so): decay, update and norm pass
    round as the JAX oracles do."""
    p, _, u, a = _flat_inputs("bfloat16", seed=7)
    g = np.asarray(np.random.RandomState(8).randn(N), np.float32)
    kw = dict(beta=0.9, wd=1e-2, apply=apply)
    tp, tu = array_to_tensor(p).clone(), torch.from_numpy(u.copy())
    got = ops.fused_update(tp, torch.from_numpy(g), tu, torch.from_numpy(a),
                           torch.tensor(0.37), **kw)
    first, usq = (tp, got) if apply else got
    rf, ru, rq = jref.fused_update_ref(jnp.asarray(p), jnp.asarray(g),
                                       jnp.asarray(u), jnp.asarray(a),
                                       jnp.float32(0.37), **kw)
    assert _bitwise(rf, first) and _bitwise(ru, tu) and _rel(rq, usq) <= 1e-6
    assert first.dtype == (torch.bfloat16 if apply else torch.float32)
    sq = ops.chunk_sumsq(torch.from_numpy(g), array_to_tensor(p), wd=1e-2)
    want = jref.chunk_sumsq_ref(jnp.asarray(g), jnp.asarray(p), wd=1e-2)
    assert _rel(want, sq) <= 1e-6


def test_deferred_wrapper_writes_the_given_buffer_and_leaves_p():
    p, g, u, a = _flat_inputs("float32", seed=9)
    tp, tu = torch.from_numpy(p.copy()), torch.from_numpy(u.copy())
    buf = torch.full((N,), 7.0)
    reset_launches()
    out, _ = ops.fused_update(tp, torch.from_numpy(g), tu, torch.from_numpy(a),
                              torch.tensor(0.1), beta=0.9, wd=0.0, apply=False,
                              out=buf)
    assert out is buf and torch.equal(tp, torch.from_numpy(p))
    assert torch.equal(buf, tu)           # no nesterov: the direction is u_new
    assert launch_counts()["fused_update_deferred"] == 0
    with pytest.raises(ValueError, match="apply=False"):
        ops.fused_update(tp, torch.from_numpy(g), tu, torch.from_numpy(a),
                         torch.tensor(0.1), beta=0.9, wd=0.0, out=buf)


def test_wd_zero_keeps_negative_zero_gradients():
    g = torch.zeros(ref.TILE)
    g[::3] = -0.0
    p = torch.ones(ref.TILE)
    ge = ref.decay(g.view(-1, ref.CHUNK), p.view(-1, ref.CHUNK), 0.0, False)
    assert torch.equal(torch.signbit(ge.view(-1)), torch.signbit(g))


def test_plain_row_sum_is_the_pairwise_halving_tree():
    x = torch.from_numpy(np.random.RandomState(3).randn(5, ref.CHUNK)
                         .astype(np.float32))
    want = x.clone()
    w = ref.CHUNK
    while w > 1:
        w //= 2
        want = torch.stack([want[:, j] + want[:, j + w] for j in range(w)], 1)
    assert torch.equal(ref.row_sum(x), want[:, 0])


def test_wrapper_on_cpu_runs_plain_version_without_launching():
    p, g, u, a = _flat_inputs("float32")
    reset_launches()
    ops.chunk_sumsq(array_to_tensor(g))
    ops.fused_update(array_to_tensor(p), array_to_tensor(g),
                     torch.from_numpy(u), torch.from_numpy(a),
                     torch.tensor(0.1), beta=0.9, wd=0.0)
    assert launch_counts()["chunk_sumsq"] == 0
    assert launch_counts()["fused_update"] == 0


@pytest.mark.parametrize("bad", ["size", "dtype", "device", "stride"])
def test_wrapper_checks_reject_what_the_kernel_does_not_take(bad):
    x = torch.zeros(ref.TILE)
    dev = x.device
    if bad == "size":
        x = torch.zeros(ref.TILE + ref.CHUNK)
    elif bad == "dtype":
        x = torch.zeros(ref.TILE, dtype=torch.float16)
    elif bad == "device":
        dev = torch.device("meta")
    else:
        x = torch.zeros(2 * ref.TILE)[::2]
    with pytest.raises((TypeError, ValueError)):
        ops._check_flat("x", x, ops._DTYPE_CODES, dev)


# ---------------------------------------------------------------------------
# layout, flatten, unflatten
# ---------------------------------------------------------------------------

SHAPES = {"blocks": {"L0": {"attn": {"wq": (3, 300, 17)}, "scale": (3, 7)},
                     "L10": {"w": (1025,)}, "L2": {"w": (2, 64)}},
          "embed": (64, 64), "final_norm": {"scale": ()}, "z": (0,),
          "a": (2000,)}


def _tree(seed, dtype="float32", mixed=False, scale=1.0):
    """A nested numpy tree over SHAPES; ``mixed`` stores two leaves in
    bf16 beside the others."""
    r = np.random.RandomState(seed)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        dt = DTYPES[dtype]
        if mixed and path[-1] in ("w", "scale"):
            dt = DTYPES["bfloat16"]
        return np.asarray(scale * r.randn(*node), np.float32).astype(dt)
    return walk(SHAPES, ())


def test_leaf_order_is_the_jax_tree_order():
    tree = _tree(0)
    jax_paths = [".".join(k.key for k in path) for path, _ in
                 jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert tmt.leaf_order(from_numpy_tree(tree)) == jax_paths


@pytest.mark.parametrize("mixed", [False, True])
def test_layout_and_flatten_match_jax(mixed):
    tree = _tree(0, mixed=mixed)
    jl = jmt.build_layout(tree)
    tt = from_numpy_tree(tree)
    tl = tmt.build_layout(tt)
    assert len(tl.buckets) == len(jl.buckets) == (2 if mixed else 1)
    for jb, tb in zip(jl.buckets, tl.buckets):
        assert (jb.dtype.name, jb.n_elems, jb.n_chunks) == \
            (tmt.dtype_name(tb.dtype), tb.n_elems, tb.n_chunks)
        assert [(s.index, s.offset, s.size, s.shape, s.chunk_lo, s.chunk_hi)
                for s in jb.segments] == \
            [(s.index, s.offset, s.size, s.shape, s.chunk_lo, s.chunk_hi)
             for s in tb.segments]
    for jf, tf in zip(jmt.flatten(tree, jl), tmt.flatten(tt, tl)):
        assert _bitwise(jf, tf)
    back = tmt.unflatten(tmt.flatten(tt, tl), tl)
    assert tuple(back) == tl.paths
    assert all(torch.equal(back[k], tt[k]) and back[k].dtype == tt[k].dtype
               for k in tt)


def test_unflatten_gives_views_into_the_buffers():
    tt = from_numpy_tree(_tree(1, mixed=True))
    layout = tmt.build_layout(tt)
    flats = tmt.flatten(tt, layout)
    views = tmt.unflatten(flats, layout)
    spans = {b.dtype: (f.data_ptr(), f.data_ptr() + f.numel() * f.element_size())
             for b, f in zip(layout.buckets, flats)}
    for k, v in views.items():
        if v.numel() == 0:
            continue                  # an empty view has no address
        lo, hi = spans[v.dtype]
        assert lo <= v.data_ptr() and v.data_ptr() + v.numel() * v.element_size() <= hi


def test_fold_sum_and_leaf_sumsq_match_jax():
    r = np.random.RandomState(2)
    for n in (1, 2, 3, 7, 64, 1000, 1025):
        x = np.asarray(r.rand(n), np.float32)
        assert _bitwise(jmt._fold_sum(jnp.asarray(x)),
                        tmt._fold_sum(torch.from_numpy(x)))
    for shape in ((0,), (), (5, 7), (3000,)):
        x = np.asarray(r.randn(*shape), np.float32)
        assert _rel(jmt.leaf_sumsq(jnp.asarray(x)),
                    tmt.leaf_sumsq(torch.from_numpy(x))) <= 1e-6


# ---------------------------------------------------------------------------
# optimizer steps
# ---------------------------------------------------------------------------

def _run_port(name, kw, fused, dtype, steps=3, mixed=False):
    opt = topt.make_optimizer(name, tpoly(0.5, 10), beta=0.9,
                              weight_decay=1e-4, fused=fused, **kw)
    ts = opt.init_state(from_numpy_tree(_tree(0, dtype, mixed)))
    stats = []
    for t in range(steps):
        ts, st = opt.step_state(from_numpy_tree(_tree(t + 1, dtype, mixed)), ts)
        stats.append({k: float(v) for k, v in st.items()})
    return ts, stats


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,kw", KINDS, ids=KIND_IDS)
def test_port_fused_equals_port_plain_bitwise(name, kw, dtype):
    a, sa = _run_port(name, kw, None, dtype)
    b, sb = _run_port(name, kw, "multi_tensor", dtype)
    assert isinstance(a.opt_state, topt.OptState)
    assert isinstance(b.opt_state, tmt.FlatOptState) and b.params is None
    assert sa == sb
    pa, pb = a.params_view, b.params_view
    ua, ub = a.opt_state.momentum, b.opt_state.momentum
    for k in pa:
        assert pa[k].dtype == pb[k].dtype and _bitwise(pa[k], pb[k]), k
        assert _bitwise(ua[k], ub[k]), k


def test_per_step_packing_path_equals_plain_bitwise_on_mixed_dtypes():
    for name, kw in KINDS[:4]:
        a, sa = _run_port(name, kw, None, "float32", mixed=True)
        opt = topt.make_optimizer(name, tpoly(0.5, 10), beta=0.9,
                                  weight_decay=1e-4, fused="multi_tensor", **kw)
        p = from_numpy_tree(_tree(0, "float32", True))
        st = topt.OptState(0, {k: torch.zeros(v.shape) for k, v in p.items()})
        for t in range(3):                      # OptState: per-step packing
            p, st, _ = opt.step(from_numpy_tree(_tree(t + 1, "float32", True)),
                                st, p)
        assert all(_bitwise(p[k], a.params[k]) for k in p), name
        assert all(_bitwise(st.momentum[k], a.opt_state.momentum[k])
                   for k in p), name


def _run_port_per_step(name, kw, dtype, steps=3):
    """The engine's per-step packing path (``multi_tensor_step``): an
    ``OptState`` fed to the fused optimizer."""
    opt = topt.make_optimizer(name, tpoly(0.5, 10), beta=0.9,
                              weight_decay=1e-4, fused="multi_tensor", **kw)
    p = from_numpy_tree(_tree(0, dtype))
    st = topt.OptState(0, {k: torch.zeros(v.shape) for k, v in p.items()})
    stats = []
    for t in range(steps):
        p, st, s = opt.step(from_numpy_tree(_tree(t + 1, dtype)), st, p)
        stats.append({k: float(v) for k, v in s.items()})
    return topt.TrainState(p, st), stats


@pytest.mark.parametrize("form", ["resident", "per_step"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,kw", KINDS[:5], ids=KIND_IDS[:5])
def test_engine_matches_jax_plain_path(name, kw, dtype, form):
    if form == "resident":
        ts, stats = _run_port(name, kw, "multi_tensor", dtype)
        assert isinstance(ts.opt_state, tmt.FlatOptState)
    else:
        ts, stats = _run_port_per_step(name, kw, dtype)
    opt = jopt.make_optimizer(name, jpoly(0.5, 10), beta=0.9, weight_decay=1e-4,
                              fused=None, **kw)
    jp = jax.tree.map(jnp.asarray, _tree(0, dtype))
    js = opt.init(jp)
    for t in range(3):
        jp, js, jst = opt.step(jax.tree.map(jnp.asarray, _tree(t + 1, dtype)),
                               js, jp)
        for k in ("grad_norm", "lr", "update_norm"):
            assert abs(float(jst[k]) - stats[t][k]) <= 1e-6 * abs(float(jst[k])), (t, k)
    want_p = from_numpy_tree(jax.tree.map(np.asarray, jp))
    want_u = from_numpy_tree(jax.tree.map(np.asarray, js.momentum))
    got_p, got_u = ts.params_view, ts.opt_state.momentum
    for k in want_p:
        assert got_p[k].dtype == want_p[k].dtype
        assert _rel(want_p[k], got_p[k]) <= STEP_REL[dtype], k
        assert _rel(want_u[k], got_u[k]) <= STEP_REL[dtype], k


def test_resident_step_leaves_params_in_place_and_counts_steps():
    ts, _ = _run_port("sngm", {}, "multi_tensor", "float32", steps=1)
    ptrs = [f.data_ptr() for f in ts.opt_state.p_flats]
    opt = topt.make_optimizer("sngm", tpoly(0.5, 10), fused="multi_tensor")
    new, _ = opt.step_state(from_numpy_tree(_tree(5)), ts)
    assert [f.data_ptr() for f in new.opt_state.p_flats] == ptrs
    assert new.step == 2 and new.params is None


@pytest.mark.parametrize("name,kw,launches", [
    ("sngm", {}, 2), ("sngm", {"norm_mode": "per_tensor"}, 2), ("msgd", {}, 2),
    ("lars", {}, 3), ("sngm", {"nesterov": True}, 2)],
    ids=["sngm", "sngm_per_tensor", "msgd", "lars", "sngm_nesterov"])
def test_launch_counts_per_step(monkeypatch, name, kw, launches):
    calls = []

    def counting(fn):
        def wrapped(*a, **k):
            calls.append(fn.__name__)
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(ops, "chunk_sumsq", counting(ops.chunk_sumsq))
    monkeypatch.setattr(ops, "fused_update", counting(ops.fused_update))
    for t in range(2):
        calls.clear()
        _run_port(name, kw, "multi_tensor", "float32", steps=1)
        assert len(calls) == launches, calls
        assert calls.count("fused_update") == 1
    calls.clear()
    _run_port(name, kw, None, "float32", steps=1)
    assert calls == []


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _cuda_inputs(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode "
                    "(chip_smoke.py runs them on the card)")
    return [array_to_tensor(x).cuda() for x in _flat_inputs(dtype, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_chunk_sumsq_matches_plain_bitwise(dtype):
    p, g, _, _ = _cuda_inputs(dtype)
    for wd in (0.0, 1e-4):
        assert _bitwise(ops.chunk_sumsq(g, p, wd=wd),
                        ref.chunk_sumsq_ref(g, p, wd=wd))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_fused_update_matches_plain_bitwise(dtype):
    p, g, u, a = _cuda_inputs(dtype)
    for wd in (0.0, 1e-4):
        for cast_g_first in (False, True):
            for nesterov in (False, True):
                kw = dict(beta=0.9, wd=wd, cast_g_first=cast_g_first,
                          nesterov=nesterov)
                rp, ru, rq = ref.fused_update_ref(p, g, u, a, torch.tensor(0.37), **kw)
                kp, ku = p.clone(), u.clone()
                kq = ops.fused_update(kp, g, ku, a, torch.tensor(0.37), **kw)
                torch.cuda.synchronize()
                assert _bitwise(kp, rp) and _bitwise(ku, ru)
                assert _bitwise(kq, rq)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_fused_update_deferred_matches_plain_bitwise(dtype):
    p, g, u, a = _cuda_inputs(dtype)
    for wd in (0.0, 1e-4):
        for nesterov in (False, True):
            kw = dict(beta=0.9, wd=wd, nesterov=nesterov, apply=False)
            ro, ru, rq = ref.fused_update_ref(p, g, u, a, torch.tensor(0.37), **kw)
            kp, ku = p.clone(), u.clone()
            ko, kq = ops.fused_update(kp, g, ku, a, torch.tensor(0.37), **kw)
            torch.cuda.synchronize()
            assert _bitwise(kp, p) and _bitwise(ko, ro) and _bitwise(ku, ru)
            assert _bitwise(kq, rq)


def test_zero_dim_arrays_cross_with_their_shape():
    for x in (np.float32(1.5), np.asarray(2.0, np.float32),
              np.asarray(-0.0, DTYPES["bfloat16"]), jnp.asarray(3.0)):
        t = array_to_tensor(np.asarray(x))
        assert t.shape == () and _bitwise(np.asarray(x), t)
        assert tensor_to_array(t).shape == ()


def test_resident_path_packs_nothing_and_per_step_path_packs_three_buffers():
    params = from_numpy_tree(_tree(0))
    grads = from_numpy_tree(_tree(1))
    opt = topt.make_optimizer("sngm", tpoly(0.5, 10), fused="multi_tensor")
    ts = opt.init_state(params)
    layout = ts.opt_state.layout
    flat = tmt.FlatGrads(tuple(tmt.flatten(grads, layout)), layout)
    with tmt.count_packed_bytes() as c:
        ts, _ = opt.step_state(flat, ts)
    assert c["bytes"] == 0 and c["buffers"] == 0
    bucket_bytes = sum(b.n_elems * 4 for b in layout.buckets)
    with tmt.count_packed_bytes() as c:
        opt.step(grads, topt.OptState(0, ts.opt_state.momentum), params)
    assert c["bytes"] == 3 * bucket_bytes and c["buffers"] == 3
