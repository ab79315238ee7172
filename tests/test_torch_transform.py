"""The port's gradient-transform chains and chain compiler against the
JAX package (``repro.core.transform``), and against the port's own
interpreter.

Inputs are numpy arrays drawn from a seed and handed to both sides, on
the small trees of ``tests/test_chain_differential.py``'s grid (ragged
shapes, a scalar, a size-0 leaf; fp32, bf16 and mixed).  Bounds held,
and why:

  * each stage and ``interpreter_step`` against the JAX interpreter:
    within 2e-6 of each leaf's largest magnitude in fp32 and 2e-2 in
    bf16 (the norms sum rows in another order than XLA's ``jnp.sum``, a
    few ulp, and the normalize and clip stages divide by them); purely
    elementwise stages bitwise;
  * ``match_chain`` and ``plan_chain``: the same kinds, parameters, node
    ops, stages, labels, launch counts, slots and blockers as the JAX
    package's on every chain of that file's deterministic grid, EMA
    chains included (the schedule is compared by name only: each
    package has its own);
  * ``compile_chain(fused="multi_tensor")`` against the port's own
    interpreter, 2 steps: bitwise, except lars and a trailing clip,
    which are held to the JAX grid's "close" bound (fp32 rtol 5e-4 /
    atol 1e-6, bf16 rtol 5e-2 / atol 1e-2; the JAX grid,
    ``test_chain_differential.py:140-168``, allows it for every clip,
    nesterov and prefix chain too, for XLA's contractions, which eager
    PyTorch does not make); kernel calls per step equal to the plan's
    launches per bucket times the buckets;
  * the port against JAX ``compile_chain`` for 3 steps from one state
    carried across by ``convert.py``: fp32 2e-6, bf16 2e-2 of each
    leaf's largest magnitude.  For lars and sngm_per_tensor at fp32 the
    JAX side is its ``fused=None`` path (ROADMAP Queue C: the JAX engine
    misses its own jnp path by an ulp there on this jax);
  * ``convert.py``'s chain states across: bitwise.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import ml_dtypes

from repro.core import optim as jopt
from repro.core import transform as JT
from repro.core import schedules as JS
from repro_torch.convert import (chain_state_from_numpy, from_numpy_tree,
                                 lamb_state_from_numpy,
                                 plan_state_from_numpy, tensor_to_array,
                                 train_state_from_numpy)
from repro_torch.core import multi_tensor as tmt
from repro_torch.core import optim as topt
from repro_torch.core import schedules as TS
from repro_torch.core import transform as TT
from repro_torch.kernels.multi_tensor import ops

DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
STEP_REL = {"float32": 2e-6, "bfloat16": 2e-2}
# the trees of test_chain_differential.py's SPEC_GRID: shapes, dtypes, seed,
# gradient scale
SPECS = {
    "f32": (((300, 17), (1030,), (), (0,), (4,)), ("float32",) * 5, 3, 3.0),
    "bf16": (((33, 5), (1030,), (), (7, 3)), ("bfloat16",) * 4, 5, 3.0),
    "mixed": (((129,), (16, 16), (), (0,), (40, 3)),
              ("float32", "bfloat16", "float32", "bfloat16", "float32"),
              7, 1.0),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _trees(spec, n_grads=3):
    """(params, [grads per step]) as numpy trees keyed p0, p1, ..."""
    shapes, dtypes, seed, gscale = SPECS[spec]
    r = np.random.RandomState(seed)

    def draw(scale):
        return {f"p{i}": np.asarray(scale * r.randn(*s), np.float32)
                .astype(DTYPES[d]) for i, (s, d) in enumerate(zip(shapes, dtypes))}
    params = draw(1.0)
    return params, [draw(gscale) for _ in range(n_grads)]


def _f32(x):
    if isinstance(x, torch.Tensor):
        x = tensor_to_array(x)
    return np.asarray(x).astype(np.float32)


def _rel(want, got):
    want, got = _f32(want), _f32(got)
    assert want.shape == got.shape, (want.shape, got.shape)
    if not want.size:
        return 0.0
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(want - got).max()) / scale


def _bitwise(a, b):
    a, b = _f32(a), _f32(b)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(want, got, dtype, label):
    """Per leaf: dtype equal and within STEP_REL of the leaf's max;
    ``want`` a JAX tree or a port dict."""
    if not all(isinstance(v, torch.Tensor) for v in want.values()):
        want = from_numpy_tree(_np(want))
    assert set(want) == set(got), label
    for k in want:
        assert want[k].dtype == got[k].dtype, (label, k)
        bound = STEP_REL["bfloat16" if got[k].dtype == torch.bfloat16 else dtype]
        assert _rel(want[k], got[k]) <= bound, (label, k, _rel(want[k], got[k]))


# ---------------------------------------------------------------------------
# chains, built the same way in either package
# ---------------------------------------------------------------------------

def canonical(M, S, kind, clip=None, wd=1e-4, with_wd_stage=True, beta=0.9,
              nesterov=False, sched=None):
    """``test_chain_differential.build_canonical`` over either package's
    transform module ``M`` and schedules ``S``."""
    sched = sched or S.poly_power(0.3, 10, 1.1)
    prefix = (M.clip_by_global_norm(clip),) if clip is not None else ()
    adw = (M.add_decayed_weights(wd),) if with_wd_stage else ()
    if kind == "lamb":
        body = (M.scale_by_adam(0.9, 0.999, 1e-6),) + adw + \
            (M.scale_by_trust_ratio(), M.scale_by_schedule(sched))
    elif kind == "lars":
        body = (M.trust_ratio(0.001, wd), M.scale_by_schedule(sched),
                M.trace(beta, nesterov=nesterov))
    elif kind == "msgd":
        body = adw + (M.trace(beta, nesterov=nesterov), M.scale_by_schedule(sched))
    else:
        norm = (M.normalize_by_global_norm() if kind == "sngm_global"
                else M.normalize_per_tensor())
        body = adw + (norm, M.trace(beta, nesterov=nesterov),
                      M.scale_by_schedule(sched))
    return M.chain(*(prefix + body))


def _poly(S):
    return S.poly_power(0.3, 10, 1.1)


# the plan chains of test_chain_differential.py's deterministic grid
PLAN_CHAINS = {
    "clip_mid": lambda M, S: M.chain(
        M.add_decayed_weights(1e-4), M.normalize_by_global_norm(),
        M.clip_by_global_norm(5.0), M.trace(0.9), M.scale_by_schedule(_poly(S))),
    "suffix_clip": lambda M, S: M.chain(
        M.add_decayed_weights(1e-4), M.normalize_by_global_norm(),
        M.trace(0.9), M.scale_by_schedule(_poly(S)), M.clip_by_global_norm(0.01)),
    "ema": lambda M, S: M.chain(
        M.add_decayed_weights(1e-4), M.normalize_by_global_norm(),
        M.trace(0.9), M.scale_by_schedule(_poly(S)), M.ema_params(0.99)),
    "clip_nesterov_ema": lambda M, S: M.chain(
        M.clip_by_global_norm(1.0), M.trace(0.9, nesterov=True),
        M.scale_by_schedule(S.constant(0.1)), M.ema_params(0.99)),
    "novel_prefix": lambda M, S: M.chain(
        M.normalize_by_global_norm(), M.add_decayed_weights(0.1),
        M.normalize_by_global_norm(), M.trace(0.9),
        M.scale_by_schedule(S.constant(0.1))),
    "novel_adam_trace": lambda M, S: M.chain(
        M.scale_by_adam(0.9, 0.999, 1e-6), M.trace(0.9),
        M.scale_by_schedule(S.constant(0.1))),
    "novel_sched_trace": lambda M, S: M.chain(
        M.scale_by_schedule(S.constant(0.1)), M.trace(0.9)),
    # the launch-count section's chains, and a nested chain
    "clip_mid_short": lambda M, S: M.chain(
        M.normalize_by_global_norm(), M.clip_by_global_norm(5.0), M.trace(0.9),
        M.scale_by_schedule(S.constant(0.1))),
    "suffix_short": lambda M, S: M.chain(
        M.normalize_by_global_norm(), M.trace(0.9),
        M.scale_by_schedule(S.constant(0.1)), M.clip_by_global_norm(0.01)),
    "lamb_clip_no_wd": lambda M, S: M.chain(
        M.clip_by_global_norm(1.0), M.scale_by_adam(0.9, 0.999, 1e-6),
        M.scale_by_trust_ratio(), M.scale_by_schedule(S.constant(0.1))),
    "lamb_eps0": lambda M, S: M.chain(
        M.scale_by_adam(0.9, 0.999, 0.0), M.scale_by_trust_ratio(),
        M.scale_by_schedule(S.constant(0.1))),
    "nested": lambda M, S: M.chain(
        M.chain(M.add_decayed_weights(1e-4), M.normalize_by_global_norm()),
        M.chain(M.trace(0.9), M.scale_by_schedule(_poly(S)))),
}
GRID = {**{f"{k}-clip{c}": (lambda M, S, k=k, c=c: canonical(M, S, k, c))
           for k in ("sngm_global", "sngm_per_tensor", "msgd", "lars", "lamb")
           for c in (None, 0.5)},
        "sngm_global-nesterov": lambda M, S: canonical(M, S, "sngm_global",
                                                       nesterov=True),
        **PLAN_CHAINS}


def _no_schedule(kw):
    return {k: v for k, v in dict(kw).items() if k != "schedule"}


@pytest.mark.parametrize("name", sorted(GRID))
def test_match_and_plan_equal_the_jax_packages(name):
    jtx, ttx = GRID[name](JT, JS), GRID[name](TT, TS)
    assert [p.name for p in ttx.parts] == [p.name for p in jtx.parts]
    jm, tm = JT.match_chain(jtx), TT.match_chain(ttx)
    assert (jm is None) == (tm is None)
    if jm is not None:
        assert tm[0] == jm[0] and _no_schedule(tm[1]) == _no_schedule(jm[1])
        assert "schedule" in tm[1]
    jp, tp = JT.plan_chain(jtx), TT.plan_chain(ttx)
    assert (tp.kind, tp.slots, tp.blocker) == (jp.kind, jp.slots, jp.blocker)
    assert tp.describe() == jp.describe()
    assert tp.launches_per_bucket() == jp.launches_per_bucket()
    assert len(tp.nodes) == len(jp.nodes)
    for a, b in zip(tp.nodes, jp.nodes):
        assert (a.op, a.stages, a.label, a.launches, a.kind) == \
            (b.op, b.stages, b.label, b.launches, b.kind)
        assert _no_schedule(a.kwargs) == _no_schedule(b.kwargs)
        assert [k for k, _ in a.kwargs] == [k for k, _ in b.kwargs]
        assert (a.transform is None) == (b.transform is None)
        if a.transform is not None:
            assert a.transform.name == b.transform.name


# ---------------------------------------------------------------------------
# each stage, and the interpreter, against the JAX interpreter
# ---------------------------------------------------------------------------

STAGES = {
    "add_decayed_weights": lambda M, S: M.add_decayed_weights(1e-2),
    "normalize_by_global_norm": lambda M, S: M.normalize_by_global_norm(),
    "normalize_per_tensor": lambda M, S: M.normalize_per_tensor(),
    "clip_acting": lambda M, S: M.clip_by_global_norm(1.0),
    "clip_idle": lambda M, S: M.clip_by_global_norm(1e6),
    "trace": lambda M, S: M.trace(0.9),
    "trace_nesterov": lambda M, S: M.trace(0.5, nesterov=True),
    "trust_ratio": lambda M, S: M.trust_ratio(0.001, 1e-4),
    "scale_by_trust_ratio": lambda M, S: M.scale_by_trust_ratio(),
    "scale_by_adam": lambda M, S: M.scale_by_adam(0.9, 0.999, 1e-6),
    "scale_by_schedule": lambda M, S: M.scale_by_schedule(_poly(S)),
}
# purely elementwise on these inputs: the same bits as JAX
BITWISE_STAGES = ("add_decayed_weights", "clip_idle", "trace",
                  "trace_nesterov", "scale_by_schedule")


def _state_trees(s):
    """The dict-valued fields of a (port) stage state, by name."""
    return {k: v for k, v in s._asdict().items() if isinstance(v, dict)}


@pytest.mark.parametrize("spec", ["f32", "mixed"])
@pytest.mark.parametrize("name", sorted(STAGES))
def test_stage_matches_jax(name, spec):
    """Two updates of one stage on both sides (the second from the
    carried state), outputs, states and stats compared."""
    params, grads = _trees(spec, 2)
    jtx, ttx = STAGES[name](JT, JS), STAGES[name](TT, TS)
    jp = jax.tree.map(jnp.asarray, params)
    tp = from_numpy_tree(params)
    js, ts = jtx.init(jp), ttx.init(tp)
    for g in grads:
        ju, js, jst = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts, tst = ttx.update(from_numpy_tree(g), ts, tp)
        want = from_numpy_tree(_np(ju))
        if name in BITWISE_STAGES:
            assert all(want[k].dtype == tu[k].dtype and _bitwise(want[k], tu[k])
                       for k in want), name
        else:
            _close(want, tu, "float32", name)
        assert set(jst) == set(tst)
        for k in jst:
            assert _rel(jst[k], tst[k]) <= 1e-6, (name, k)
        for field, tree in _state_trees(ts).items():
            _close(getattr(js, field), tree, "float32", f"{name} {field}")
        if "count" in ts._fields:
            assert ts.count == int(js.count)


INTERP_CHAINS = {
    "sngm_clip": lambda M, S: canonical(M, S, "sngm_global", clip=0.5),
    "lamb_clip": lambda M, S: canonical(M, S, "lamb", clip=0.5),
    "lars": lambda M, S: canonical(M, S, "lars"),
    "clip_mid": PLAN_CHAINS["clip_mid"],
    "suffix_clip": PLAN_CHAINS["suffix_clip"],
    "novel_adam_trace": PLAN_CHAINS["novel_adam_trace"],
}


@pytest.mark.parametrize("spec", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(INTERP_CHAINS))
def test_interpreter_matches_jax(name, spec):
    params, grads = _trees(spec)
    jopt_ = JT.compile_chain(INTERP_CHAINS[name](JT, JS), interpret=True)
    topt_ = TT.compile_chain(INTERP_CHAINS[name](TT, TS), interpret=True)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt_.init(jp)
    ts = topt_.init_state(from_numpy_tree(params))
    assert isinstance(ts.opt_state, TT.ChainOptState)
    dtype = "bfloat16" if spec == "bf16" else "float32"
    for t, g in enumerate(grads):
        jp, js, jst = jopt_.step(jax.tree.map(jnp.asarray, g), js, jp)
        ts, tst = topt_.step_state(from_numpy_tree(g), ts)
        assert set(jst) == set(tst)
        for k in jst:
            assert _rel(jst[k], tst[k]) <= 1e-5, (name, t, k)
    _close(jp, ts.params, dtype, name)
    assert ts.step == int(js.step) == len(grads)
    for j_s, t_s in zip(js.inner, ts.opt_state.inner):
        assert type(j_s).__name__ == type(t_s).__name__
        for field, tree in _state_trees(t_s).items():
            _close(getattr(j_s, field), tree, "float32", f"{name} {field}")


def test_interpreter_refuses_a_missing_params_view():
    opt = TT.compile_chain(canonical(TT, TS, "msgd"), interpret=True)
    state = opt.init(from_numpy_tree(_trees("f32")[0]))
    with pytest.raises(TypeError, match="carry no resident parameter"):
        opt.step(from_numpy_tree(_trees("f32")[1][0]), state, None)


# ---------------------------------------------------------------------------
# the compiled chain against the port's interpreter
# ---------------------------------------------------------------------------

def _counting(monkeypatch):
    """Count the engine's kernel calls (the wrappers of ``ops``)."""
    calls = []
    for fn_name in ("chunk_sumsq", "fused_update", "scale_apply", "adam_update"):
        fn = getattr(ops, fn_name)

        def wrapped(*a, _fn=fn, _name=fn_name, **k):
            calls.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(ops, fn_name, wrapped)
    return calls


def _policy(tx):
    """test_chain_differential.py's agreement level against the
    interpreter, from the plan."""
    plan = TT.plan_chain(tx)
    kp = dict(plan.fused.kwargs)
    if plan.kind == "lamb":
        return "bitwise"
    if plan.kind == "lars":
        return "close"
    clippy = kp.get("clip") is not None or kp.get("suffix_clip") is not None
    prefix = any(n.op == "jnp" for n in plan.nodes)
    return "close" if clippy or kp.get("nesterov") or prefix else "bitwise"


def _port_policy(tx):
    """The port's own bound, at least as tight: eager PyTorch contracts no
    multiply-add, so a compiled chain is bitwise its interpreter except
    for lars (lr inside the per-tensor coefficient) and a trailing clip
    (``lr * ||u||`` against ``||lr * u||``: an association)."""
    plan = TT.plan_chain(tx)
    suffix = dict(plan.fused.kwargs).get("suffix_clip") is not None
    policy = "close" if plan.kind == "lars" or suffix else "bitwise"
    assert policy == "bitwise" or _policy(tx) == "close"
    return policy


def _agree(want, got, policy, label):
    assert set(want) == set(got), label
    for k in want:
        assert want[k].dtype == got[k].dtype, (label, k)
        if policy == "bitwise":
            assert _bitwise(want[k], got[k]), (label, k)
        elif got[k].dtype == torch.bfloat16:
            np.testing.assert_allclose(_f32(got[k]), _f32(want[k]), rtol=5e-2,
                                       atol=1e-2, err_msg=f"{label} {k}")
        else:
            np.testing.assert_allclose(_f32(got[k]), _f32(want[k]), rtol=5e-4,
                                       atol=1e-6, err_msg=f"{label} {k}")


def _port_state_trees(st):
    """The momentum / Adam moment dicts of any port state form."""
    if isinstance(st, tmt.FlatOptState):
        return st.moments if st.m_flats else (st.momentum,)
    out = []
    for s in st.inner:
        if isinstance(s, TT.TraceState):
            out.append(s.momentum)
        elif isinstance(s, TT.ScaleByAdamState):
            out.extend((s.m, s.v))
    return tuple(out)


COMPILED = {
    "sngm_global": lambda: canonical(TT, TS, "sngm_global"),
    "sngm_clip": lambda: canonical(TT, TS, "sngm_global", clip=0.5),
    "sngm_per_tensor_clip": lambda: canonical(TT, TS, "sngm_per_tensor", clip=0.5),
    "sngm_nesterov_clip": lambda: canonical(TT, TS, "sngm_global", clip=0.5,
                                            nesterov=True),
    "msgd_clip": lambda: canonical(TT, TS, "msgd", clip=0.5),
    "lars_clip": lambda: canonical(TT, TS, "lars", clip=0.5),
    "lamb_clip": lambda: canonical(TT, TS, "lamb", clip=0.5),
    "clip_mid": lambda: PLAN_CHAINS["clip_mid"](TT, TS),
    "suffix_clip": lambda: PLAN_CHAINS["suffix_clip"](TT, TS),
    "suffix_clip_nesterov_msgd": lambda: TT.chain(
        TT.trace(0.9, nesterov=True), TT.scale_by_schedule(TS.constant(0.1)),
        TT.clip_by_global_norm(0.05)),
    "novel_prefix": lambda: PLAN_CHAINS["novel_prefix"](TT, TS),
    "lamb_prefix": lambda: TT.chain(
        TT.normalize_by_global_norm(), TT.scale_by_adam(0.9, 0.999, 1e-6),
        TT.scale_by_trust_ratio(), TT.scale_by_schedule(TS.constant(0.1))),
}


@pytest.mark.parametrize("spec", ["f32", "mixed"])
@pytest.mark.parametrize("name", sorted(COMPILED))
def test_compiled_chain_matches_port_interpreter(name, spec, monkeypatch):
    tx = COMPILED[name]()
    params, grads = _trees(spec, 2)
    interp = TT.compile_chain(tx, interpret=True)
    fused = TT.compile_chain(tx, fused="multi_tensor")
    plan = fused.plan
    assert fused.kind == plan.kind is not None
    a = interp.init_state(from_numpy_tree(params))
    b = fused.init_state(from_numpy_tree(params))
    assert isinstance(b.opt_state, tmt.FlatOptState) and b.params is None
    calls = _counting(monkeypatch)
    n_buckets = len(b.opt_state.layout.buckets)
    policy = _port_policy(tx)
    for t, g in enumerate(grads):
        a, sa = interp.step_state(from_numpy_tree(g), a)
        calls.clear()
        b, sb = fused.step_state(from_numpy_tree(g), b)
        assert len(calls) == plan.launches_per_bucket() * n_buckets, (t, calls)
        assert torch.equal(sa["lr"], sb["lr"])
        for k in ("grad_norm", "update_norm"):
            _agree({k: sa[k]}, {k: sb[k]}, policy, f"{name} stat")
    _agree(a.params, b.params_view, policy, f"{name} params")
    for x, y in zip(_port_state_trees(a.opt_state),
                    _port_state_trees(b.opt_state)):
        _agree(x, y, policy, f"{name} state")


def test_clip_prefix_engine_is_bitwise_its_plain_path():
    """The kind-level clip: engine (resident, per-step packing) and plain
    path take the same clip expression on the same raw norm."""
    for spec in ("f32", "mixed"):
        params, grads = _trees(spec, 2)
        for kind in ("sngm_global", "msgd", "lars", "lamb"):
            outs = []
            for fused in (None, "multi_tensor"):
                opt = TT.compile_chain(canonical(TT, TS, kind, clip=0.5),
                                       fused=fused)
                ts = opt.init_state(from_numpy_tree(params))
                for g in grads:
                    ts, st = opt.step_state(from_numpy_tree(g), ts)
                outs.append((ts.params_view, st))
            (pa, sa), (pb, sb) = outs
            assert all(_bitwise(pa[k], pb[k]) for k in pa), (spec, kind)
            assert all(_bitwise(sa[k], sb[k]) for k in sa), (spec, kind)


def test_flat_and_tree_clip_rounds_agree_bitwise():
    params, grads = _trees("mixed", 1)
    g = from_numpy_tree(grads[0])
    layout = tmt.build_layout(g)
    flats = tmt.flatten(g, layout)
    ct, nt = tmt._clip_tree_round(g, layout, 0.5)
    cf, nf = tmt._clip_flats_round(flats, layout, 0.5)
    assert _bitwise(nt, nf) and _bitwise(nt, tmt.global_norm(g))
    assert _bitwise(tmt.flat_global_norm(flats, layout), nt)
    back = tmt.unflatten(cf, layout)
    assert all(_bitwise(ct[k], back[k]) and ct[k].dtype == back[k].dtype for k in ct)
    jl = jax.tree.map(jnp.asarray, grads[0])
    from repro.core import multi_tensor as jmt
    jflats = jmt.flatten(jl, jmt.build_layout(jl))
    assert _rel(jmt.flat_global_norm(jflats, jmt.build_layout(jl)), nf) <= 1e-6


def test_resident_clip_accepts_flat_grads():
    """A resident state fed the engine's FlatGrads (what the train step
    accumulates) steps the same bits as fed the gradient dict."""
    params, grads = _trees("mixed", 2)
    for tx in (canonical(TT, TS, "sngm_global", clip=0.5),
               PLAN_CHAINS["suffix_clip"](TT, TS), PLAN_CHAINS["clip_mid"](TT, TS)):
        opt = TT.compile_chain(tx, fused="multi_tensor")
        a = opt.init_state(from_numpy_tree(params))
        b = opt.init_state(from_numpy_tree(params))
        layout = b.opt_state.layout
        for g in grads:
            a, sa = opt.step_state(from_numpy_tree(g), a)
            flat = tmt.FlatGrads(tuple(tmt.flatten(from_numpy_tree(g), layout)),
                                 layout)
            b, sb = opt.step_state(flat, b)
            assert all(_bitwise(sa[k], sb[k]) for k in sa)
        assert all(_bitwise(a.params_view[k], b.params_view[k]) for k in params)


# ---------------------------------------------------------------------------
# the port against JAX compile_chain, from one state
# ---------------------------------------------------------------------------

# (chain, spec, JAX execution mode, the port's); lars at fp32 against the
# JAX fused=None path (ROADMAP Queue C)
ACROSS = {
    "sngm_clip-f32": (lambda M, S: canonical(M, S, "sngm_global", clip=0.5),
                      "f32", "multi_tensor", "multi_tensor"),
    "lars_clip-f32": (lambda M, S: canonical(M, S, "lars", clip=0.5), "f32",
                      None, "multi_tensor"),
    "lamb_clip-bf16": (lambda M, S: canonical(M, S, "lamb", clip=0.5), "bf16",
                       "multi_tensor", "multi_tensor"),
    "clip_mid-mixed": (PLAN_CHAINS["clip_mid"], "mixed", "multi_tensor",
                       "multi_tensor"),
    "suffix_clip-f32": (PLAN_CHAINS["suffix_clip"], "f32", "multi_tensor",
                        "multi_tensor"),
    "suffix_clip-bf16": (PLAN_CHAINS["suffix_clip"], "bf16", "multi_tensor",
                         "multi_tensor"),
    "novel_adam_trace-f32": (PLAN_CHAINS["novel_adam_trace"], "f32", None, None),
}


def _to_port(jp, js, resident):
    """A JAX state (any form) and its params -> the port's TrainState,
    through ``convert.py``."""
    if isinstance(js, JT.ChainOptState):
        return chain_state_from_numpy(_np(jp), _np(js))
    if isinstance(js, jopt.OptState):
        return train_state_from_numpy(_np(jp), _np(js.momentum), int(js.step),
                                      resident=resident)
    params = _np(js.params)
    if js.form[0] == "chain":
        kw = {"momentum": _np(js.momentum)} if js.u_flats else {}
        if js.m_flats:
            kw = dict(zip("mv", map(_np, js.moments)))
        return plan_state_from_numpy(params, js.form[1], int(js.step), **kw)
    if js.m_flats:
        return lamb_state_from_numpy(params, *map(_np, js.moments), int(js.step),
                                     resident=True)
    return train_state_from_numpy(params, _np(js.momentum), int(js.step),
                                  resident=True)


@pytest.mark.parametrize("case", sorted(ACROSS))
def test_port_matches_jax_from_one_state(case):
    """One JAX step from init, its state carried to the port through
    ``convert.py``, then 3 more steps on both sides on the same
    gradients."""
    build, spec, jfused, tfused = ACROSS[case]
    params, grads = _trees(spec, 4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # novel: interpreter
        jo = JT.compile_chain(build(JT, JS), fused=jfused)
        to = TT.compile_chain(build(TT, TS), fused=tfused)
    jp = jax.tree.map(jnp.asarray, params)
    js = jo.init(jp)
    jp, js, _ = jo.step(jax.tree.map(jnp.asarray, grads[0]), js, jp)
    ts = _to_port(jp, js, resident=tfused is not None)
    assert ts.step == 1
    dtype = "bfloat16" if spec == "bf16" else "float32"
    for g in grads[1:]:
        jp, js, jst = jo.step(jax.tree.map(jnp.asarray, g), js, jp)
        ts, tst = to.step_state(from_numpy_tree(g), ts)
        for k in jst:
            assert _rel(jst[k], tst[k]) <= 1e-5, (case, k)
    _close(jp, ts.params_view, dtype, case)
    assert ts.step == int(js.step) == 4


def test_chain_states_cross_bitwise():
    params, grads = _trees("mixed", 2)
    jtx = JT.chain(JT.scale_by_adam(0.9, 0.999, 1e-6), JT.trace(0.9),
                   JT.scale_by_schedule(JS.constant(0.1)))
    opt = JT.compile_chain(jtx, interpret=True)
    jp = jax.tree.map(jnp.asarray, params)
    js = opt.init(jp)
    for g in grads:
        jp, js, _ = opt.step(jax.tree.map(jnp.asarray, g), js, jp)
    ts = chain_state_from_numpy(_np(jp), _np(js))
    inner = ts.opt_state.inner
    assert [type(s).__name__ for s in inner] == \
        ["ScaleByAdamState", "TraceState", "ScaleByScheduleState"]
    assert ts.step == inner[0].count == inner[2].count == 2
    for a, b in ((js.inner[0].m, inner[0].m), (js.inner[0].v, inner[0].v),
                 (js.inner[1].momentum, inner[1].momentum), (jp, ts.params)):
        a = from_numpy_tree(_np(a))
        assert all(a[k].dtype == b[k].dtype and _bitwise(a[k], b[k]) for k in a)
    # a plan state (trace slot) across, bitwise
    jo = JT.compile_chain(PLAN_CHAINS["clip_mid"](JT, JS), fused="multi_tensor")
    jst = jo.init(jax.tree.map(jnp.asarray, params))
    _, jst, _ = jo.step(jax.tree.map(jnp.asarray, grads[0]), jst, None)
    ps = _to_port(None, jst, resident=True)
    assert ps.opt_state.form == jst.form and ps.params is None
    for jf, tf in zip(jst.p_flats + jst.u_flats,
                      ps.opt_state.p_flats + ps.opt_state.u_flats):
        assert _bitwise(np.asarray(jf), tf)


# ---------------------------------------------------------------------------
# the compiler's other promises
# ---------------------------------------------------------------------------

def test_fallback_warnings_carry_the_jax_messages():
    novel = PLAN_CHAINS["novel_sched_trace"]
    plan_only = PLAN_CHAINS["clip_mid"]
    for build, fused in ((novel, "multi_tensor"), (plan_only, "per_leaf")):
        with pytest.warns(UserWarning) as want:
            JT.compile_chain(build(JT, JS), fused=fused)
        with pytest.warns(UserWarning) as got:
            opt = TT.compile_chain(build(TT, TS), fused=fused)
        assert str(got[0].message) == str(want[0].message)
        state = opt.init(from_numpy_tree(_trees("f32")[0]))
        assert isinstance(state, TT.ChainOptState)


def test_ema_params_raises_naming_the_roadmap():
    """Ported since (EMA shadow parameters): every call that raised now
    runs, and nothing names the roadmap.  The engine's slots are held
    bitwise to the interpreter in ``tests/test_torch_ema.py``."""
    tx = PLAN_CHAINS["ema"](TT, TS)
    assert TT.plan_chain(tx).kind == "sngm_global"
    params, grads = _trees("f32", 1)
    params, g = from_numpy_tree(params), from_numpy_tree(grads[0])
    engine = TT.compile_chain(tx, fused="multi_tensor")
    interp = TT.compile_chain(tx, interpret=True)
    assert isinstance(engine.init(params), tmt.FlatOptState)
    st = TT.ema_params(0.9).init(params)
    assert isinstance(st, TT.EmaParamsState)
    assert all(torch.equal(st.ema[k], params[k]) for k in params)
    _, new, _ = TT.interpreter_step(tx, g, interp.init(params), params)
    assert isinstance(new.inner[-1], TT.EmaParamsState) and new.step == 1
    opt = topt.sngm(TS.constant(0.1), ema_decay=0.99)
    assert opt.plan.describe().endswith("ema[0]:0.99")
    assert not hasattr(TT, "EMA_NOT_PORTED")


@pytest.mark.parametrize("name,kw,launches", [
    ("sngm", {}, 2), ("msgd", {}, 2), ("lars", {}, 3), ("lamb", {}, 2),
    ("sngm", {"nesterov": True}, 2)],
    ids=["sngm", "msgd", "lars", "lamb", "sngm_nesterov"])
def test_builders_compile_through_compile_chain(name, kw, launches, monkeypatch):
    opt = topt.make_optimizer(name, TS.constant(0.1), fused="multi_tensor", **kw)
    assert opt.plan is not None and opt.plan.launches_per_bucket() == launches
    jopt_ = jopt.make_optimizer(name, JS.constant(0.1), fused="multi_tensor", **kw)
    assert opt.plan.describe() == jopt_.plan.describe() and opt.kind == jopt_.kind
    params = from_numpy_tree(_trees("f32")[0])
    ts = opt.init_state(params)
    # 1x resident bytes: the buffers own the parameters, nothing else does
    assert ts.params is None
    assert sum(f.numel() * f.element_size() for f in ts.opt_state.p_flats) == \
        sum(b.n_elems * 4 for b in ts.opt_state.layout.buckets)
    calls = _counting(monkeypatch)
    opt.step_state(from_numpy_tree(_trees("f32")[1][0]), ts)
    assert len(calls) == launches


def test_clip_sngm_takes_three_launches(monkeypatch):
    opt = TT.compile_chain(canonical(TT, TS, "sngm_global", clip=1.0),
                           fused="multi_tensor")
    assert opt.plan.launches_per_bucket() == 3
    params, grads = _trees("f32", 1)
    ts = opt.init_state(from_numpy_tree(params))
    calls = _counting(monkeypatch)
    opt.step_state(from_numpy_tree(grads[0]), ts)
    assert sorted(calls) == ["chunk_sumsq", "chunk_sumsq", "fused_update"]


def test_train_step_takes_a_chain():
    """``make_train_step`` compiles a chain on the spot (the interpreter,
    as JAX's does); the chain compiled for the engine trains through the
    engine's flat gradients.  Same losses, close params."""
    from repro_torch import prng
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.data import SyntheticLM
    from repro_torch.models import make_runtime, materialize, model_defs
    from repro_torch.training import make_train_step
    cfg = smoke_variant(get_config("gemma-2b"))
    rt = make_runtime("cpu", remat=False)
    tx = PLAN_CHAINS["suffix_clip"](TT, TS)
    data = SyntheticLM(cfg.vocab_size, 16, 4, seed=0, device=rt.device)
    runs = []
    for opt in (tx, TT.compile_chain(tx, fused="multi_tensor")):
        params = materialize(model_defs(cfg), prng.PRNGKey(0), rt.device)
        state = TT.as_optimizer(opt).init_state(params)
        step = make_train_step(cfg, rt, opt, n_micro=2)
        losses = []
        for t in range(2):
            state, stats = step(state, data.batch_at(t))
            losses.append(float(stats["loss"]))
        runs.append((state, losses))
    (a, la), (b, lb) = runs
    assert isinstance(a.opt_state, TT.ChainOptState)
    assert isinstance(b.opt_state, tmt.FlatOptState) and b.step == 2
    assert la[0] == lb[0] and abs(la[1] - lb[1]) <= 1e-5 * abs(la[1])
    _agree(a.params, b.params_view, "close", "train step")
