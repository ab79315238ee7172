"""EMA shadow parameters in the port (``ema_params``, the resident
``FlatOptState.e_flats`` slots, ``sngm(ema_decay=)``) against the JAX
package's (``repro.core.transform.ema_params``,
``repro.core.multi_tensor.init_ema_flats`` / ``ema_flats_update``), and
against the port's own interpreter.

Inputs are numpy arrays drawn from a seed and handed to both sides, on
the small trees of ``tests/test_torch_transform.py`` (ragged shapes, a
scalar, a size-0 leaf; fp32, bf16 and mixed).  Torch runs at 2 threads.
Bounds held, and why:

  * ``ema_params`` init and one update against the JAX stage, decay 0.5,
    0.99 and 0.999, fp32, bf16 and mixed trees: bitwise.  The advance is
    two products and one add, each rounded, on both sides (the JAX side
    runs op by op; under ``jax.jit`` XLA's CPU backend may contract it
    into a fused multiply-add, decay 0.5 excepted);
  * the shadow never aliases the params: changing the params after init
    leaves it as it was (interpreter and engine);
  * one EMA advance on the engine against the JAX engine, from one state
    carried across by ``convert.plan_state_from_numpy``: the slots
    bitwise (they read only the pre-step params and the old shadow,
    which are the same bits on both sides); the advance taken a slice at
    a time bitwise the whole-bucket advance;
  * 3 steps against JAX ``compile_chain`` from one state: params and
    EMA slots within 2e-6 (fp32) / 2e-2 (bf16) of each leaf's largest
    magnitude, the chains' bound in ``tests/test_torch_transform.py``;
    stats 1e-5 relative.  For lars and sngm_per_tensor at fp32 the JAX
    side is its ``fused=None`` path (ROADMAP Queue C);
  * the port's engine against the port's interpreter, 3 steps, decay 0.5
    and 0.99, with and without nesterov and a clip prefix, fp32, bf16
    and mixed: params, momentum and EMA slots bitwise (sign of zero
    included);
  * kernel calls a step equal to the plan's launches (SNGM + EMA 2,
    nesterov 2, a clip prefix 3), and the counters equal to the JAX
    package's: packed bytes those of plain resident SNGM (the gradients
    only), ``param_bytes_live`` 1x (the shadow is optimizer state);
  * ``to_pytree`` / ``from_pytree`` and ``convert.py`` in both directions:
    bitwise; the ``per_leaf`` fallback warning word for word the JAX
    package's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import ml_dtypes

from repro.core import multi_tensor as jmt
from repro.core import optim as jopt
from repro.core import schedules as JS
from repro.core import transform as JT
from repro.tracker import counters as jc
from repro_torch.convert import (chain_state_from_numpy, from_numpy_tree,
                                 plan_state_from_numpy, tensor_to_array,
                                 to_numpy_tree)
from repro_torch.core import multi_tensor as tmt
from repro_torch.core import optim as topt
from repro_torch.core import schedules as TS
from repro_torch.core import transform as TT
from repro_torch.kernels import count_kernel_calls
from repro_torch.tracker import counters as tc

DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
STEP_REL = {"float32": 2e-6, "bfloat16": 2e-2}
SPECS = {
    "f32": (((300, 17), (1030,), (), (0,), (4,)), ("float32",) * 5, 3, 3.0),
    "bf16": (((33, 5), (1030,), (), (7, 3)), ("bfloat16",) * 4, 5, 3.0),
    "mixed": (((129,), (16, 16), (), (0,), (40, 3)),
              ("float32", "bfloat16", "float32", "bfloat16", "float32"),
              7, 1.0),
}
DECAYS = (0.5, 0.99, 0.999)


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


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bits(x):
    """A tensor's or array's bits (sign of zero included)."""
    if isinstance(x, torch.Tensor):
        x = tensor_to_array(x)
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.array_equal(_bits(a), _bits(b))


def _same_tree(want, got, label):
    """Per leaf: the port's tensor the JAX (numpy) leaf's bits and dtype."""
    want = from_numpy_tree(_np(want)) if not all(
        isinstance(v, torch.Tensor) for v in want.values()) else want
    assert set(want) == set(got), label
    for k in want:
        assert want[k].dtype == got[k].dtype, (label, k)
        assert _same(tensor_to_array(want[k]), tensor_to_array(got[k])), \
            (label, k)


def _rel(want, got):
    want = np.asarray(tensor_to_array(want) if isinstance(want, torch.Tensor)
                      else want).astype(np.float32)
    got = np.asarray(tensor_to_array(got) if isinstance(got, torch.Tensor)
                     else got).astype(np.float32)
    assert want.shape == got.shape
    if not want.size:
        return 0.0
    return float(np.abs(want - got).max()) / max(float(np.abs(want).max()), 1e-30)


def _close(want, got, label):
    want = from_numpy_tree(_np(want))
    assert set(want) == set(got), label
    for k in want:
        assert want[k].dtype == got[k].dtype, (label, k)
        bound = STEP_REL["bfloat16" if got[k].dtype == torch.bfloat16
                         else "float32"]
        assert _rel(want[k], got[k]) <= bound, (label, k, _rel(want[k], got[k]))


def _poly(S):
    return S.poly_power(0.3, 10, 1.1)


# chains with an EMA stage, built the same way in either package
CHAINS = {
    "sngm_nesterov_ema": lambda M, S, d=0.99: M.chain(
        M.add_decayed_weights(1e-4), M.normalize_by_global_norm(),
        M.trace(0.9, nesterov=True), M.scale_by_schedule(_poly(S)),
        M.ema_params(d)),
    "clip_sngm_ema": lambda M, S, d=0.99: M.chain(
        M.clip_by_global_norm(0.5), M.add_decayed_weights(1e-4),
        M.normalize_by_global_norm(), M.trace(0.9),
        M.scale_by_schedule(_poly(S)), M.ema_params(d)),
    # tests/test_torch_transform.py's PLAN_CHAINS "ema" and "clip_nesterov_ema"
    "ema": lambda M, S, d=0.99: M.chain(
        M.add_decayed_weights(1e-4), M.normalize_by_global_norm(),
        M.trace(0.9), M.scale_by_schedule(_poly(S)), M.ema_params(d)),
    "clip_nesterov_ema": lambda M, S, d=0.99: M.chain(
        M.clip_by_global_norm(1.0), M.trace(0.9, nesterov=True),
        M.scale_by_schedule(S.constant(0.1)), M.ema_params(d)),
    "sngm_per_tensor_ema": lambda M, S, d=0.99: M.chain(
        M.add_decayed_weights(1e-4), M.normalize_per_tensor(), M.trace(0.9),
        M.scale_by_schedule(_poly(S)), M.ema_params(d)),
    "lars_ema": lambda M, S, d=0.99: M.chain(
        M.trust_ratio(0.001, 1e-4), M.scale_by_schedule(_poly(S)),
        M.trace(0.9), M.ema_params(d)),
}


# ---------------------------------------------------------------------------
# the stage: init and update against the JAX stage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_ema_params_init_and_update_bitwise_the_jax_stage(spec, decay):
    params, grads = _trees(spec, 2)
    jtx, ttx = JT.ema_params(decay), TT.ema_params(decay)
    assert ttx.name == jtx.name and ttx.meta == jtx.meta
    jp, tp = jax.tree.map(jnp.asarray, params), from_numpy_tree(params)
    js, ts = jtx.init(jp), ttx.init(tp)
    assert type(ts).__name__ == type(js).__name__ == "EmaParamsState"
    _same_tree(js.ema, ts.ema, "init")
    assert all(v.dtype == torch.float32 for v in ts.ema.values())
    # the params move between updates, as they do in training
    for g in grads:
        ju, js, jst = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts, tst = ttx.update(from_numpy_tree(g), ts, tp)
        assert jst == {} and tst == {}
        _same_tree(ju, tu, "updates pass through")
        _same_tree(js.ema, ts.ema, "ema")
        jp = jax.tree.map(lambda w, u: (w - u).astype(w.dtype), jp, ju)
        tp = {k: (w - tu[k]).to(w.dtype) for k, w in tp.items()}


def test_shadow_never_aliases_the_params():
    """fp32 params: ``.to(float32)`` would return the tensor itself; the
    shadow of the stage and of the engine's slots must be copies."""
    params = from_numpy_tree(_trees("mixed", 0)[0])
    st = TT.ema_params(0.9).init(params)
    layout = tmt.build_layout(params)
    p_flats = tmt.flatten(params, layout)
    e_flats = tmt.init_ema_flats(params, layout)
    opt = topt.sngm(TS.constant(0.1), ema_decay=0.9, fused="multi_tensor")
    ts = opt.init_state(params)
    before = [x.clone() for x in (list(st.ema.values()) + list(e_flats)
                                  + list(ts.opt_state.e_flats[0]))]
    with torch.no_grad():
        for v in params.values():
            v.add_(1.0)
        for f in p_flats + list(ts.opt_state.p_flats):
            f.add_(1.0)
    after = list(st.ema.values()) + list(e_flats) + list(ts.opt_state.e_flats[0])
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    for e, p in zip(e_flats, p_flats):
        assert e.untyped_storage().data_ptr() != p.untyped_storage().data_ptr()


# ---------------------------------------------------------------------------
# the engine: one advance against the JAX engine, from one state
# ---------------------------------------------------------------------------

def _jax_plan_state(spec, decay, chain="ema", steps=1):
    """A JAX engine state of ``chain`` after ``steps`` steps from init."""
    params, grads = _trees(spec, steps + 1)
    jo = JT.compile_chain(CHAINS[chain](JT, JS, decay), fused="multi_tensor")
    js = jo.init(jax.tree.map(jnp.asarray, params))
    for g in grads[:steps]:
        _, js, _ = jo.step(jax.tree.map(jnp.asarray, g), js, None)
    return jo, js, grads[steps]


def _port_of(js):
    """A JAX ``("chain", slots)`` engine state -> the port's TrainState."""
    kw = {"momentum": _np(js.momentum)} if js.u_flats else {}
    return plan_state_from_numpy(_np(js.params), js.form[1], int(js.step),
                                 emas=[_np(e) for e in js.ema_views], **kw)


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_one_engine_advance_bitwise_the_jax_engine(spec, decay):
    jo, js, g = _jax_plan_state(spec, decay)
    ts = _port_of(js)
    st = ts.opt_state
    assert st.form == js.form and len(st.e_flats) == 1
    for jf, tf in zip(js.p_flats + js.u_flats + js.e_flats[0],
                      st.p_flats + st.u_flats + st.e_flats[0]):
        assert _same(np.asarray(jf), tensor_to_array(tf))
    # the advance alone, on copies
    want = jmt.ema_flats_update(js.e_flats[0], js.p_flats, decay)
    got = tmt.ema_flats_update([e.clone() for e in st.e_flats[0]],
                               st.p_flats, decay)
    assert all(_same(np.asarray(w), tensor_to_array(t))
               for w, t in zip(want, got))
    # one whole step each: the slots read only the pre-step params
    to = TT.compile_chain(CHAINS["ema"](TT, TS, decay), fused="multi_tensor")
    _, js2, _ = jo.step(jax.tree.map(jnp.asarray, g), js, None)
    ts2, _ = to.step_state(from_numpy_tree(g), ts)
    assert all(_same(np.asarray(w), tensor_to_array(t))
               for w, t in zip(js2.e_flats[0], ts2.opt_state.e_flats[0]))


def test_advance_in_slices_is_bitwise_the_whole_bucket(monkeypatch):
    params = from_numpy_tree(_trees("mixed", 0)[0])
    layout = tmt.build_layout(params)
    p_flats = tmt.flatten({k: v * 3 for k, v in params.items()}, layout)
    whole = tmt.ema_flats_update(tmt.init_ema_flats(params, layout), p_flats,
                                 0.999)
    monkeypatch.setattr(tmt, "EMA_SLICE", 1000)
    sliced = tmt.ema_flats_update(tmt.init_ema_flats(params, layout), p_flats,
                                  0.999)
    assert all(torch.equal(a, b) for a, b in zip(whole, sliced))
    assert max(e.numel() for e in sliced) > 1000


# ---------------------------------------------------------------------------
# trajectories against the JAX package
# ---------------------------------------------------------------------------

def _compiled(chain, side, fused):
    """``chain`` compiled by one package (``side`` "jax" or "port"); the
    "sngm" entry through the ``sngm(ema_decay=)`` builder itself."""
    O, M, S = (jopt, JT, JS) if side == "jax" else (topt, TT, TS)
    if chain == "sngm":
        return O.sngm(_poly(S), weight_decay=1e-4, ema_decay=0.999, fused=fused)
    return M.compile_chain(CHAINS[chain](M, S), fused=fused)


# (chain, spec, JAX execution mode, the port's); lars and sngm_per_tensor
# at fp32 against the JAX fused=None path (ROADMAP Queue C)
ACROSS = {
    "sngm-f32": ("sngm", "f32", "multi_tensor", "multi_tensor"),
    "sngm-bf16": ("sngm", "bf16", "multi_tensor", "multi_tensor"),
    "sngm-mixed": ("sngm", "mixed", "multi_tensor", "multi_tensor"),
    "sngm-f32-interpreter": ("sngm", "f32", None, None),
    "ema-f32": ("ema", "f32", "multi_tensor", "multi_tensor"),
    "ema-bf16": ("ema", "bf16", "multi_tensor", "multi_tensor"),
    "clip_nesterov_ema-f32": ("clip_nesterov_ema", "f32", "multi_tensor",
                              "multi_tensor"),
    "clip_nesterov_ema-bf16": ("clip_nesterov_ema", "bf16", "multi_tensor",
                               "multi_tensor"),
    "sngm_per_tensor_ema-f32": ("sngm_per_tensor_ema", "f32", None,
                                "multi_tensor"),
    "lars_ema-f32": ("lars_ema", "f32", None, "multi_tensor"),
}


def _to_port(jp, js):
    if isinstance(js, JT.ChainOptState):
        return chain_state_from_numpy(_np(jp), _np(js))
    return _port_of(js)


def _port_emas(ts):
    st = ts.opt_state
    if isinstance(st, tmt.FlatOptState):
        return st.ema_views
    return tuple(s.ema for s in st.inner if isinstance(s, TT.EmaParamsState))


def _jax_emas(js):
    if isinstance(js, JT.ChainOptState):
        return tuple(s.ema for s in js.inner if isinstance(s, JT.EmaParamsState))
    return js.ema_views


@pytest.mark.parametrize("case", sorted(ACROSS))
def test_port_matches_jax_from_one_state(case):
    """One JAX step from init, its state carried to the port through
    ``convert.py``, then 3 more steps on both sides on the same
    gradients: params and EMA slots within the chain bound."""
    chain, spec, jfused, tfused = ACROSS[case]
    params, grads = _trees(spec, 4)
    jo, to = _compiled(chain, "jax", jfused), _compiled(chain, "port", tfused)
    assert to.plan.describe() == jo.plan.describe()
    jp = jax.tree.map(jnp.asarray, params)
    js = jo.init(jp)
    jp, js, _ = jo.step(jax.tree.map(jnp.asarray, grads[0]), js, jp)
    if jfused is not None:
        jp = js.params
    ts = _to_port(jp, js)
    if tfused is not None and not isinstance(ts.opt_state, tmt.FlatOptState):
        ts = topt.TrainState.wrap(None, topt.from_pytree(ts.opt_state,
                                                         ts.params))
    assert ts.step == 1
    for g in grads[1:]:
        jp, js, jst = jo.step(jax.tree.map(jnp.asarray, g), js, jp)
        ts, tst = to.step_state(from_numpy_tree(g), ts)
        assert set(jst) == set(tst)
        for k in jst:
            assert _rel(np.asarray(jst[k]), tst[k]) <= 1e-5, (case, k)
    if jfused is not None:
        jp = js.params
    _close(jp, ts.params_view, f"{case} params")
    (je,), (te,) = _jax_emas(js), _port_emas(ts)
    _close(je, te, f"{case} ema")
    assert ts.step == int(js.step) == 4


# ---------------------------------------------------------------------------
# the engine against the port's interpreter
# ---------------------------------------------------------------------------

def _slots(ts):
    """Params, momentum and EMA dicts of a port TrainState, any form."""
    st = ts.opt_state
    if isinstance(st, tmt.FlatOptState):
        return [ts.params_view, st.momentum, *st.ema_views]
    out = [ts.params]
    for s in st.inner:
        if isinstance(s, TT.TraceState):
            out.append(s.momentum)
        elif isinstance(s, TT.EmaParamsState):
            out.append(s.ema)
    return out


@pytest.mark.parametrize("decay", [0.5, 0.99])
@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("chain", ["ema", "sngm_nesterov_ema",
                                   "clip_sngm_ema"])
def test_engine_bitwise_the_port_interpreter(chain, spec, decay):
    """``test_chain_differential.py``'s EMA check on the port: 3 steps,
    params, momentum and EMA slots bitwise, sign of zero included."""
    params, grads = _trees(spec)
    tx = CHAINS[chain](TT, TS, decay)
    interp = TT.compile_chain(tx, interpret=True)
    fused = TT.compile_chain(tx, fused="multi_tensor")
    a = interp.init_state(from_numpy_tree(params))
    b = fused.init_state(from_numpy_tree(params))
    assert isinstance(b.opt_state, tmt.FlatOptState) and b.params is None
    assert b.opt_state.form == ("chain", fused.plan.slots)
    for g in grads:
        a, sa = interp.step_state(from_numpy_tree(g), a)
        b, sb = fused.step_state(from_numpy_tree(g), b)
        assert all(torch.equal(sa[k], sb[k]) for k in ("lr", "grad_norm",
                                                        "update_norm"))
    for x, y in zip(_slots(a), _slots(b), strict=True):
        _same_tree(x, y, chain)


def test_sngm_ema_decay_builds_the_chain_in_every_mode():
    """``sngm(ema_decay=)`` appends ``ema_params`` as the JAX builder does:
    the engine's segment plan, the interpreter otherwise; ``per_leaf``
    warns as the JAX package does, word for word, and interprets."""
    for fused in (None, "multi_tensor"):
        jo = jopt.sngm(JS.constant(0.1), ema_decay=0.99, fused=fused)
        to = topt.sngm(TS.constant(0.1), ema_decay=0.99, fused=fused)
        assert to.plan.describe() == jo.plan.describe()
        assert to.kind == jo.kind and to.name == jo.name
    with pytest.warns(UserWarning) as want:
        jopt.sngm(JS.constant(0.1), ema_decay=0.99, fused="per_leaf")
    with pytest.warns(UserWarning) as got:
        to = topt.sngm(TS.constant(0.1), ema_decay=0.99, fused="per_leaf")
    assert [str(w.message) for w in got] == [str(w.message) for w in want]
    assert "runs only on the multi-tensor engine" in str(got[0].message)
    params = from_numpy_tree(_trees("f32", 0)[0])
    st = to.init(params)
    assert isinstance(st, TT.ChainOptState)
    assert isinstance(st.inner[-1], TT.EmaParamsState)


# ---------------------------------------------------------------------------
# counts and counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chain,launches", [("ema", 2),
                                            ("sngm_nesterov_ema", 2),
                                            ("clip_sngm_ema", 3)])
@pytest.mark.parametrize("spec", ["f32", "mixed"])
def test_calls_and_counters_equal_the_plan_and_the_jax_package(spec, chain,
                                                               launches):
    params, grads = _trees(spec, 1)
    tp = from_numpy_tree(params)
    jparams = jax.tree.map(jnp.asarray, params)
    to = TT.compile_chain(CHAINS[chain](TT, TS), fused="multi_tensor")
    jo = JT.compile_chain(CHAINS[chain](JT, JS), fused="multi_tensor")
    assert to.plan.launches_per_bucket() == launches
    n_buckets = len(tmt.build_layout(tp).buckets)
    ts = to.init_state({k: v.clone() for k, v in tp.items()})
    with count_kernel_calls() as c:
        to.step_state(from_numpy_tree(grads[0]), ts)
    assert c["launches"] == launches * n_buckets
    got, want = tc.engine_counters(to, tp), jc.engine_counters(jo, jparams)
    assert got == want
    assert tc.plan_launches_per_step(to, tp) == \
        jc.plan_launches_per_step(jo, jparams) == launches * n_buckets
    # packing: what plain resident SNGM (or clipped SNGM) packs, gradients
    # only; live params 1x, the shadow being optimizer state
    plain = TT.compile_chain(TT.chain(*CHAINS[chain](TT, TS).parts[:-1]),
                             fused="multi_tensor")
    base = tc.engine_counters(plain, tp)
    assert got["packed_bytes_per_step"] == base["packed_bytes_per_step"]
    assert got["launches_per_step"] == base["launches_per_step"]
    raw = sum(b.n_elems * torch.empty((), dtype=b.dtype).element_size()
              for b in tmt.build_layout(tp).buckets)
    assert got["param_bytes_live"] == base["param_bytes_live"] == raw


# ---------------------------------------------------------------------------
# state forms and conversions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["f32", "bf16", "mixed"])
def test_to_pytree_from_pytree_round_trip_bitwise(spec):
    params, grads = _trees(spec, 2)
    opt = TT.compile_chain(CHAINS["clip_nesterov_ema"](TT, TS),
                           fused="multi_tensor")
    ts = opt.init_state(from_numpy_tree(params))
    for g in grads:
        ts, _ = opt.step_state(from_numpy_tree(g), ts)
    s = ts.opt_state
    pt = topt.to_pytree(s)
    assert [type(x).__name__ for x in pt.inner] == \
        ["EmptyState", "TraceState", "ScaleByScheduleState", "EmaParamsState"]
    assert all(pt.inner[3].ema[k].data_ptr() == s.ema_views[0][k].data_ptr()
               for k in params)
    back = topt.from_pytree(pt, s.params)
    assert back.form == s.form and back.step == s.step == 2
    for name in ("p_flats", "u_flats", "m_flats", "v_flats"):
        assert all(torch.equal(x, y) for x, y in
                   zip(getattr(s, name), getattr(back, name), strict=True))
    assert len(back.e_flats) == len(s.e_flats) == 1
    assert all(x.dtype == y.dtype == torch.float32 and torch.equal(x, y)
               for x, y in zip(s.e_flats[0], back.e_flats[0], strict=True))
    # and the rebuilt state steps as the live one does
    g = from_numpy_tree(grads[0])
    a, _ = opt.step_state(g, ts)
    b, _ = opt.step_state(g, topt.TrainState.wrap(None, back))
    for x, y in zip(_slots(a), _slots(b), strict=True):
        _same_tree(x, y, "restepped")


@pytest.mark.parametrize("spec", ["bf16", "mixed"])
def test_convert_carries_ema_states_both_ways_bitwise(spec):
    """JAX -> port: the interpreter's ``ChainOptState`` and the engine's
    ``("chain", slots)`` state; port -> JAX: the port's states as numpy
    trees, rebuilt by the JAX package's ``from_pytree``."""
    params, grads = _trees(spec, 2)
    jparams = jax.tree.map(jnp.asarray, params)
    ji = JT.compile_chain(CHAINS["ema"](JT, JS), interpret=True)
    jp, js = jparams, ji.init(jparams)
    for g in grads:
        jp, js, _ = ji.step(jax.tree.map(jnp.asarray, g), js, jp)
    ts = chain_state_from_numpy(_np(jp), _np(js))
    inner = ts.opt_state.inner
    assert [type(s).__name__ for s in inner] == [type(s).__name__
                                                 for s in js.inner]
    _same_tree(js.inner[4].ema, inner[4].ema, "interpreter ema")
    _same_tree(jp, ts.params, "interpreter params")
    # the engine form
    _, je, _ = _jax_plan_state(spec, 0.99, steps=2)
    pe = _port_of(je)
    for jf, tf in zip(je.p_flats + je.u_flats + je.e_flats[0],
                      pe.opt_state.p_flats + pe.opt_state.u_flats
                      + pe.opt_state.e_flats[0]):
        assert _same(np.asarray(jf), tensor_to_array(tf))
    # port -> JAX: the pytree form as numpy, into the JAX engine form
    pt = topt.to_pytree(pe.opt_state)
    jinner = []
    for s in pt.inner:
        if isinstance(s, TT.TraceState):
            jinner.append(JT.TraceState(to_numpy_tree(s.momentum)))
        elif isinstance(s, TT.ScaleByScheduleState):
            jinner.append(JT.ScaleByScheduleState(np.int32(s.count)))
        elif isinstance(s, TT.EmaParamsState):
            jinner.append(JT.EmaParamsState(to_numpy_tree(s.ema)))
        else:
            jinner.append(JT.EmptyState())
    jback = jopt.from_pytree(
        JT.ChainOptState(step=np.int32(pt.step), inner=tuple(jinner)),
        to_numpy_tree(pe.params_view))
    assert jback.form == je.form
    for a, b in zip(je.p_flats + je.u_flats + je.e_flats[0],
                    jback.p_flats + jback.u_flats + jback.e_flats[0]):
        assert _same(np.asarray(a), np.asarray(b))


def test_plan_state_from_numpy_wants_one_shadow_per_ema_slot():
    params = _trees("f32", 0)[0]
    with pytest.raises(ValueError, match="one shadow tree per 'ema'"):
        plan_state_from_numpy(params, ("empty", "trace", "ema"), 0,
                              momentum=params)
    ts = plan_state_from_numpy(params, ("ema", "ema"), 3,
                               emas=[params, params])
    assert len(ts.opt_state.e_flats) == 2 and ts.step == 3
