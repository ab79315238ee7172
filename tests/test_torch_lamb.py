"""The port's LAMB against the JAX package: the two kernel passes
(``adam_update``, ``scale_apply``), the plain step, the resident engine,
the state across, and the launcher.

Inputs are numpy arrays drawn from a seed and handed to both sides.
Bounds held, and why:

  * plain passes vs the JAX package's jnp oracles
    (``repro.kernels.multi_tensor.ref``): ``m``, ``v`` and the new ``p``
    bitwise; the direction ``u`` within 2e-7 of its largest magnitude
    (PyTorch's vectorised CPU ``sqrt`` is off by one ulp on a few
    elements in a hundred, XLA's is correctly rounded; 4e-8 measured);
    the row sums of squares within 1e-6 relative (XLA adds a row in
    another order than the port's pairwise halving);
  * plain passes vs the Pallas kernels in interpret mode: fp32 within
    2e-6, bf16 within 1e-2 of the largest magnitude (XLA contracts
    multiply-adds into FMAs inside the jitted kernel body; 3e-7 and 6e-6
    measured);
  * the port's ``lamb(fused=None)`` vs the JAX chain interpreter
    (``lamb(fused=None)``) over 3 steps: params, m and v within 2e-6
    (fp32) / 2e-2 (bf16 params) of each leaf's largest magnitude, the
    stats within 1e-6 relative.  The bias corrections are bitwise the
    JAX package's (same f32 ``pow``); the per-tensor norms differ by a
    few ulp (the row sums above) and the trust ratio divides by them;
  * the port's ``lamb(fused="multi_tensor")``, resident or per-step
    packing, vs its own ``fused=None``: bitwise, fp32, bf16 and a mixed
    tree, stats included;
  * the port's engine vs the JAX package's engine: as against the
    interpreter;
  * state across (``convert.lamb_state_{from,to}_numpy``): bitwise round
    trips in both forms; one step from the same converted state within
    the interpreter bounds above;
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
from repro.core import transform as T
from repro.core.schedules import poly_power as jpoly
from repro.kernels.multi_tensor import ops as jops
from repro.kernels.multi_tensor import ref as jref
from repro_torch.convert import (array_to_tensor, from_numpy_tree,
                                 lamb_state_from_numpy, lamb_state_to_numpy,
                                 tensor_to_array)
from repro_torch.core import multi_tensor as tmt
from repro_torch.core import optim as topt
from repro_torch.core.schedules import poly_power as tpoly
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.kernels.multi_tensor import ops, ref
from repro_torch.launch import train as launcher

N = 2 * ref.TILE
DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
INTERPRET_REL = {"float32": 2e-6, "bfloat16": 1e-2}
STEP_REL = {"float32": 2e-6, "bfloat16": 2e-2}
ADAM = dict(b1=0.9, b2=0.999, eps=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _f32(x):
    if isinstance(x, torch.Tensor):
        x = tensor_to_array(x)
    return np.asarray(x).astype(np.float32)


def _rel(ref_, got):
    ref_, got = _f32(ref_), _f32(got)
    if not ref_.size:
        return 0.0
    return float(np.abs(ref_ - got).max()) / max(float(np.abs(ref_).max()), 1e-30)


def _bitwise(a, b):
    a, b = _f32(a), _f32(b)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


def _adam_inputs(dtype, case, seed=0):
    """Flat p, g (dtype), m, v (f32); ``signed_zeros`` puts zeros of both
    signs in every operand, ``padded`` zeroes the tail of the buffer from
    the middle of a row on, as a bucket's last segment and its padding
    leave it."""
    r = np.random.RandomState(seed)
    dt = DTYPES[dtype]
    p = np.asarray(r.randn(N), np.float32)
    g = np.asarray(r.randn(N), np.float32)
    m = np.asarray(r.randn(N), np.float32) * 0.1
    v = np.abs(np.asarray(r.randn(N), np.float32)) * 0.01
    if case == "signed_zeros":
        for x in (p, g, m, v):
            x[::7] = 0.0
            x[3::7] = -0.0
    elif case == "padded":
        for x in (p, g, m, v):
            x[N - 3 * ref.CHUNK - 100:] = 0.0
    return p.astype(dt), g.astype(dt), m, v


def _bcs(count=2):
    bc1, bc2 = tmt.bias_corrections(count, ADAM["b1"], ADAM["b2"])
    return bc1, bc2, np.float32(bc1.item()), np.float32(bc2.item())


# ---------------------------------------------------------------------------
# the plain passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "signed_zeros", "padded"])
@pytest.mark.parametrize("wd", [0.0, 1e-4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_adam_update_matches_jax(dtype, wd, case):
    p, g, m, v = _adam_inputs(dtype, case)
    bc1, bc2, jb1, jb2 = _bcs()
    tm, tv = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    u, usq, psq, gsq = ops.adam_update(array_to_tensor(p), array_to_tensor(g),
                                       tm, tv, bc1, bc2, wd=wd, **ADAM)
    assert u.dtype == torch.float32 and usq.shape == (N // ref.CHUNK,)
    args = (jnp.asarray(p), jnp.asarray(g), jnp.asarray(m), jnp.asarray(v),
            jb1, jb2)
    want = jref.adam_update_ref(*args, wd=wd, **ADAM)
    assert _bitwise(want[0], tm) and _bitwise(want[1], tv)
    assert _rel(want[2], u) <= 2e-7
    for w, t in zip(want[3:], (usq, psq, gsq)):
        assert _rel(w, t) <= 1e-6
    interp = jops.adam_update(*args, wd=wd, **ADAM)
    for w, t in zip(interp, (tm, tv, u, usq, psq, gsq)):
        assert _rel(w, t) <= INTERPRET_REL[dtype]
    if case == "padded":
        tail = N - 3 * ref.CHUNK - 100
        assert not bool(u[tail:].any()) and not bool(tm[tail:].any())
        assert float(usq[-2:].sum()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_scale_apply_matches_jax(dtype):
    r = np.random.RandomState(1)
    p = np.asarray(r.randn(N), np.float32).astype(DTYPES[dtype])
    u = np.asarray(r.randn(N), np.float32)
    u[::5] = -0.0
    a = np.asarray(r.rand(N // ref.CHUNK) + 0.5, np.float32)
    tp = array_to_tensor(p).clone()
    ssq = ops.scale_apply(tp, torch.from_numpy(u), torch.from_numpy(a),
                          torch.tensor(0.37))
    assert tp.dtype == TORCH_DTYPES[dtype]
    wp, wq = jref.scale_apply_ref(jnp.asarray(p), jnp.asarray(u),
                                  jnp.asarray(a), jnp.float32(0.37))
    assert _bitwise(wp, tp) and _rel(wq, ssq) <= 1e-6
    ip, iq = jops.scale_apply(jnp.asarray(p), jnp.asarray(u), jnp.asarray(a),
                              jnp.float32(0.37))
    assert _rel(ip, tp) <= INTERPRET_REL[dtype] and _rel(iq, ssq) <= 1e-6


def test_bias_corrections_are_the_jax_packages_bitwise():
    for count in range(8):
        t = jnp.asarray(count, jnp.int32).astype(jnp.float32) + 1.0
        bc1, bc2 = tmt.bias_corrections(count, 0.9, 0.999)
        assert _bitwise(1 - 0.9 ** t, bc1) and _bitwise(1 - 0.999 ** t, bc2)
        assert bc1.dtype == torch.float32 and bc1.device.type == "cpu"


def test_wrappers_on_cpu_run_plain_versions_without_launching():
    p, g, m, v = (torch.from_numpy(x) for x in _adam_inputs("float32", "random"))
    bc1, bc2, _, _ = _bcs()
    reset_launches()
    u, *_ = ops.adam_update(p, g, m, v, bc1, bc2, **ADAM)
    ops.scale_apply(p, u, torch.ones(N // ref.CHUNK), torch.tensor(0.1))
    assert launch_counts()["adam_update"] == 0
    assert launch_counts()["scale_apply"] == 0


# ---------------------------------------------------------------------------
# optimizer steps
# ---------------------------------------------------------------------------

SHAPES = {"blocks": {"L0": {"attn": {"wq": (3, 300, 17)}, "scale": (3, 7)},
                     "L10": {"w": (1025,)}, "L2": {"w": (2, 64)}},
          "embed": (64, 64), "final_norm": {"scale": ()}, "z": (0,),
          "a": (2000,)}


def _tree(seed, dtype="float32", mixed=False, scale=1.0):
    """A nested numpy tree over SHAPES; ``mixed`` stores the "w" and
    "scale" leaves in bf16 beside fp32 others."""
    r = np.random.RandomState(seed)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        dt = DTYPES[dtype]
        if mixed and path[-1] in ("w", "scale"):
            dt = DTYPES["bfloat16"]
        return np.asarray(scale * r.randn(*node), np.float32).astype(dt)
    return walk(SHAPES, ())


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _run_port(fused, dtype, steps=3, mixed=False, wd=1e-4):
    opt = topt.lamb(tpoly(0.01, 10), weight_decay=wd, fused=fused)
    ts = opt.init_state(from_numpy_tree(_tree(0, dtype, mixed)))
    stats = []
    for t in range(steps):
        ts, st = opt.step_state(from_numpy_tree(_tree(t + 1, dtype, mixed)), ts)
        stats.append({k: float(v) for k, v in st.items()})
    return ts, stats


def _run_jax(fused, dtype, steps=3, wd=1e-4):
    opt = jopt.lamb(jpoly(0.01, 10), weight_decay=wd, fused=fused)
    params = jax.tree.map(jnp.asarray, _tree(0, dtype))
    state = opt.init(params)
    stats = []
    for t in range(steps):
        params, state, st = opt.step(jax.tree.map(jnp.asarray, _tree(t + 1, dtype)),
                                     state, params)
        stats.append({k: float(v) for k, v in st.items()})
    if fused == "multi_tensor":
        params = state.params
        m, v = state.moments
    else:
        m, v = state.inner[0].m, state.inner[0].v
    return _np(params), _np(m), _np(v), stats


def _port_slots(ts):
    opt = ts.opt_state
    m, v = opt.moments if isinstance(opt, tmt.FlatOptState) else (opt.m, opt.v)
    return ts.params_view, m, v


@pytest.mark.parametrize("fused", [None, "multi_tensor"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lamb_matches_jax(dtype, fused):
    """The port's plain step against the JAX interpreter, and its engine
    against the JAX engine, over 3 steps."""
    jp, jm, jv, jstats = _run_jax(fused, dtype)
    ts, tstats = _run_port(fused, dtype)
    tp, tm_, tv = _port_slots(ts)
    for want, got, bound in ((jp, tp, STEP_REL[dtype]), (jm, tm_, STEP_REL["float32"]),
                             (jv, tv, STEP_REL["float32"])):
        want = from_numpy_tree(want)
        assert set(want) == set(got)
        for k in want:
            assert want[k].dtype == got[k].dtype, k
            assert _rel(want[k], got[k]) <= bound, (k, _rel(want[k], got[k]))
    for w, g in zip(jstats, tstats):
        assert set(w) == set(g) == {"grad_norm", "lr", "update_norm"}
        for k in w:
            assert abs(w[k] - g[k]) <= 1e-6 * abs(w[k]), (k, w[k], g[k])


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("wd", [0.0, 1e-4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lamb_engine_equals_plain_bitwise(dtype, wd, mixed):
    a, sa = _run_port(None, dtype, mixed=mixed, wd=wd)
    b, sb = _run_port("multi_tensor", dtype, mixed=mixed, wd=wd)
    assert isinstance(a.opt_state, topt.LambState)
    assert isinstance(b.opt_state, tmt.FlatOptState) and b.params is None
    assert b.opt_state.form == tmt.LAMB_FORM and b.opt_state.u_flats == ()
    assert sa == sb
    for x, y in zip(_port_slots(a), _port_slots(b)):
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and _bitwise(x[k], y[k]), k


def test_lamb_per_step_packing_equals_plain_bitwise():
    a, sa = _run_port(None, "float32", mixed=True)
    p = from_numpy_tree(_tree(0, "float32", True))
    m = {k: torch.zeros(v.shape) for k, v in p.items()}
    v = {k: torch.zeros(x.shape) for k, x in p.items()}
    stats = []
    for t in range(3):
        p, m, v, st = tmt.multi_tensor_lamb_step(
            p, from_numpy_tree(_tree(t + 1, "float32", True)), t, m, v,
            lr=tpoly(0.01, 10)(t), weight_decay=1e-4, **ADAM)
        stats.append({k: float(x) for k, x in st.items()})
    assert stats == sa
    for x, y in zip(_port_slots(a), (p, m, v)):
        assert all(_bitwise(x[k], y[k]) for k in x)


def test_lamb_state_forms_cross_paths():
    """A resident state fed to the plain step reads its views and hands
    back a ``LambState``; a ``LambState`` fed to the fused optimizer takes
    the plain step, as a ``ChainOptState`` takes the interpreter in JAX."""
    fused = topt.lamb(tpoly(0.01, 10), fused="multi_tensor")
    plain = topt.lamb(tpoly(0.01, 10))
    ts = fused.init_state(from_numpy_tree(_tree(0)))
    grads = from_numpy_tree(_tree(1))
    a, _ = plain.step_state(grads, ts)
    assert isinstance(a.opt_state, topt.LambState) and a.params is not None
    b, _ = fused.step_state(grads, plain.init_state(from_numpy_tree(_tree(0))))
    assert isinstance(b.opt_state, topt.LambState)
    assert all(_bitwise(a.params[k], b.params[k]) for k in a.params)


def test_lamb_launch_counts_per_step(monkeypatch):
    calls = []

    def counting(fn):
        def wrapped(*a, **k):
            calls.append(fn.__name__)
            return fn(*a, **k)
        return wrapped
    for name in ("adam_update", "scale_apply", "chunk_sumsq", "fused_update"):
        monkeypatch.setattr(ops, name, counting(getattr(ops, name)))
    for mixed, buckets in ((False, 1), (True, 2)):
        opt = topt.lamb(tpoly(0.01, 10), fused="multi_tensor")
        ts = opt.init_state(from_numpy_tree(_tree(0, mixed=mixed)))
        assert len(ts.opt_state.layout.buckets) == buckets
        for t in range(2):
            calls.clear()
            ts, _ = opt.step_state(from_numpy_tree(_tree(t + 1, mixed=mixed)), ts)
            assert sorted(calls) == ["adam_update"] * buckets + ["scale_apply"] * buckets
    calls.clear()
    _run_port(None, "float32", steps=1)
    assert calls == []


def test_lamb_refusals_carry_the_jax_messages():
    with pytest.raises(ValueError) as port:
        topt.lamb(tpoly(0.01, 10), fused="per_leaf")
    with pytest.raises(ValueError) as ref_:
        jopt.lamb(jpoly(0.01, 10), fused="per_leaf")
    assert str(port.value) == str(ref_.value)
    opt = topt.lamb(tpoly(0.01, 10), fused="multi_tensor")
    ts = opt.init_state(from_numpy_tree(_tree(0)))
    with pytest.raises(AssertionError, match="eps > 0"):
        tmt.resident_lamb_step(from_numpy_tree(_tree(1)), ts.opt_state,
                               lr=0.1, b1=0.9, b2=0.999, eps=0.0)


def test_adam_moments_are_distinct_zero_buffers():
    st = tmt.init_flat_adam_state(from_numpy_tree(_tree(0, mixed=True)))
    for m, v in zip(st.m_flats, st.v_flats):
        assert m.dtype == v.dtype == torch.float32
        assert m.data_ptr() != v.data_ptr() and not m.any() and not v.any()
    assert st.step == 0 and st.u_flats == ()


# ---------------------------------------------------------------------------
# the state across
# ---------------------------------------------------------------------------

def _jax_chain_state(opt, params, m, v, step):
    """The interpreter's ``ChainOptState`` holding m, v and the count."""
    st = opt.init(params)
    inner = list(st.inner)
    count = jnp.asarray(step, jnp.int32)
    inner[0] = T.ScaleByAdamState(count, jax.tree.map(jnp.asarray, m),
                                  jax.tree.map(jnp.asarray, v))
    inner[-1] = T.ScaleByScheduleState(count)
    return T.ChainOptState(count, tuple(inner))


@pytest.mark.parametrize("resident", [False, True])
def test_lamb_state_round_trip_is_bitwise(resident):
    params = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16) if a.ndim == 1 else a,
                          _tree(0))
    m = _tree(1, scale=0.1)
    v = jax.tree.map(np.abs, _tree(2, scale=0.01))
    ts = lamb_state_from_numpy(params, m, v, 3, resident=resident)
    assert isinstance(ts.opt_state, tmt.FlatOptState if resident else topt.LambState)
    assert (ts.params is None) == resident and ts.step == 3
    bp, bm, bv, step = lamb_state_to_numpy(ts)
    assert step == 3
    for a, b in ((params, bp), (m, bm), (v, bv)):
        fa, fb = from_numpy_tree(a), from_numpy_tree(b)
        assert set(fa) == set(fb)
        for k in fa:
            assert fa[k].dtype == fb[k].dtype and _bitwise(fa[k], fb[k]), k


@pytest.mark.parametrize("source", ["interpreter", "engine"])
@pytest.mark.parametrize("resident", [False, True])
def test_both_packages_step_from_the_same_converted_state(source, resident):
    """JAX state after one step (either form) -> numpy -> the port; one
    more step on both sides from there."""
    jopt_ = jopt.lamb(jpoly(0.01, 10), weight_decay=1e-4,
                      fused=None if source == "interpreter" else "multi_tensor")
    params = jax.tree.map(jnp.asarray, _tree(0))
    state = jopt_.init(params)
    params, state, _ = jopt_.step(jax.tree.map(jnp.asarray, _tree(1)), state, params)
    if source == "engine":
        params = state.params
        m, v = state.moments
    else:
        m, v = state.inner[0].m, state.inner[0].v
    ts = lamb_state_from_numpy(_np(params), _np(m), _np(v), int(state.step),
                               resident=resident)
    # JAX side continues on the interpreter from the same numbers
    jref_opt = jopt.lamb(jpoly(0.01, 10), weight_decay=1e-4)
    js = _jax_chain_state(jref_opt, params, _np(m), _np(v), int(state.step))
    g = _tree(2)
    jp, js, jst = jref_opt.step(jax.tree.map(jnp.asarray, g), js, params)
    opt = topt.lamb(tpoly(0.01, 10), weight_decay=1e-4,
                    fused="multi_tensor" if resident else None)
    ts, tst = opt.step_state(from_numpy_tree(g), ts)
    assert ts.step == 2 and int(js.step) == 2
    want = from_numpy_tree(_np(jp))
    got = ts.params_view
    assert all(_rel(want[k], got[k]) <= STEP_REL["float32"] for k in want)
    assert all(abs(float(jst[k]) - float(tst[k])) <= 1e-6 * abs(float(jst[k]))
               for k in jst)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_lamb_none_equals_multi_tensor(capsys):
    outs = {}
    for fused in ("none", "multi_tensor"):
        losses = launcher.main(["--arch", "gemma-2b", "--reduced", "--device",
                                "cpu", "--steps", "2", "--batch", "4", "--seq",
                                "32", "--log-every", "1", "--optimizer", "lamb",
                                "--lr", "0.01", "--fused", fused])
        lines = capsys.readouterr().out.splitlines()
        steps = [l.split(" (")[0] for l in lines if l.startswith("  step")]
        assert len(steps) == 2 and len(losses) == 2 and all(np.isfinite(losses))
        outs[fused] = steps
    assert outs["none"] == outs["multi_tensor"]


def test_launcher_offers_lamb_and_refuses_it_per_leaf():
    args = launcher.parse_args(["--reduced", "--device", "cpu", "--optimizer",
                                "lamb", "--fused", "per_leaf", "--steps", "1"])
    with pytest.raises(ValueError, match="not available for lamb"):
        launcher.build(args)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _cuda(*xs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode "
                    "(chip_smoke.py runs them on the card)")
    return [array_to_tensor(x).cuda() for x in xs]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "signed_zeros", "padded"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_adam_update_matches_plain_bitwise(dtype, case):
    p, g, m, v = _cuda(*_adam_inputs(dtype, case, seed=4))
    bc1, bc2, _, _ = _bcs()
    for wd in (0.0, 1e-4):
        want = ref.adam_update_ref(p, g, m, v, bc1, bc2, wd=wd, **ADAM)
        km, kv = m.clone(), v.clone()
        got = ops.adam_update(p, g, km, kv, bc1, bc2, wd=wd, **ADAM)
        torch.cuda.synchronize()
        assert all(_bitwise(w, k) for w, k in zip(want, (km, kv, *got)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_scale_apply_matches_plain_bitwise(dtype):
    r = np.random.RandomState(5)
    p, u, a = _cuda(np.asarray(r.randn(N), np.float32).astype(DTYPES[dtype]),
                    np.asarray(r.randn(N), np.float32),
                    np.asarray(r.rand(N // ref.CHUNK) + 0.5, np.float32))
    wp, wq = ref.scale_apply_ref(p, u, a, torch.tensor(0.37))
    kp = p.clone()
    kq = ops.scale_apply(kp, u, a, torch.tensor(0.37))
    torch.cuda.synchronize()
    assert _bitwise(wp, kp) and _bitwise(wq, kq)
