"""The port's per-leaf optimizer path (``fused="per_leaf"``: SNGM/SNGD
and LARS, one kernel per tensor) against its own plain path and the JAX
package's per-leaf path.

Inputs are numpy arrays drawn from a seed and handed to both sides.
Bounds held, and why:

  * plain ``sngm_update_ref`` vs the JAX oracle
    (``repro.kernels.fused_sngm.ref``): bitwise in fp32 (the same two
    roundings per op); for a bf16 leaf the port's new params are the
    JAX oracle's fp32 output rounded to bf16, bitwise.  vs the Pallas
    kernel in interpret mode: within 2e-6 of the largest magnitude (XLA
    contracts ``beta*u + g*inv`` into an FMA inside the jitted kernel);
  * plain ``lars_update_ref`` vs the JAX kernel body's expression and
    ``lars_sqnorm_ref`` folded vs the JAX ``_sqnorm``: the update bitwise
    from the same ``lr*local``, the squared norm within 5e-6 relative
    (the TPU kernel adds 32,768-element blocks one after another and XLA
    orders each block's sum itself, where the port halves 1024-element
    rows pairwise; 1.3e-6 measured at 32,769 elements); the whole JAX
    ``lars_update`` (interpret mode) within 2e-6 of the largest magnitude;
  * the port's ``fused="per_leaf"`` vs its own ``fused=None`` over 3
    steps: bitwise (params, momentum and stats), fp32 and bf16, sngm,
    sngd and lars;
  * the port's per-leaf path vs the JAX package's over 3 steps: params
    within ``atol=1e-6`` (the bound the JAX package holds between its own
    per_leaf and multi_tensor paths, ``tests/test_multi_tensor.py:311``;
    2.4e-7 measured), momentum within 2e-6 of each leaf's largest
    magnitude, stats within 1e-6 relative;
  * bf16 params: the JAX per-leaf SNGM hands back fp32 params for a
    bf16 leaf (its kernel's output type); the port keeps the leaf's
    dtype, and its value is JAX's rounded to bf16, bitwise, after one
    step;
  * on the card (``cuda`` marker): each CUDA kernel vs its plain
    version, bitwise.

The JAX per-leaf kernels refuse a size-0 leaf (the padded block is empty
and Pallas' block slice fails), so the trees held against JAX have none;
the port's own comparisons keep one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import ml_dtypes

from repro.core import optim as jopt
from repro.core.schedules import poly_power as jpoly
from repro.kernels.fused_lars import kernel as jlars_k
from repro.kernels.fused_lars import ops as jlars_ops
from repro.kernels.fused_sngm import kernel as jsngm_k
from repro.kernels.fused_sngm import ref as jsngm_ref
from repro_torch.convert import array_to_tensor, from_numpy_tree, tensor_to_array
from repro_torch.core import multi_tensor as tmt
from repro_torch.core import optim as topt
from repro_torch.core.schedules import poly_power as tpoly
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.kernels.fused_lars import ops as lars_ops
from repro_torch.kernels.fused_lars import ref as lars_ref
from repro_torch.kernels.fused_sngm import ops as sngm_ops
from repro_torch.kernels.fused_sngm import ref as sngm_ref
from repro_torch.launch import train as launcher

DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
LENGTHS = [1, 1023, 1025, 32769]
SHAPES = {"blocks": {"L0": {"attn": {"wq": (3, 300, 17)}, "scale": (3, 7)},
                     "L10": {"w": (1025,)}, "L2": {"w": (2, 64)}},
          "embed": (64, 64), "final_norm": {"scale": ()}, "z": (0,),
          "a": (2000,)}


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


def _leaf(n, dtype, seed):
    """p, g (dtype), u (f32) of n elements, with zeros of both signs."""
    r = np.random.RandomState(seed)
    p, g, u = (np.asarray(r.randn(n), np.float32) for _ in range(3))
    for x in (p, g, u):
        x[::7] = 0.0
        x[3::7] = -0.0
    return p.astype(DTYPES[dtype]), g.astype(DTYPES[dtype]), u


# ---------------------------------------------------------------------------
# the plain kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_sngm_update_matches_jax(dtype, n):
    p, g, u = _leaf(n, dtype, seed=n)
    inv, lr = np.float32(0.0123), np.float32(0.37)
    tp, tu = array_to_tensor(p).clone(), torch.from_numpy(u.copy())
    sngm_ops.fused_sngm_update(tp, array_to_tensor(g), tu, torch.tensor(inv),
                               torch.tensor(lr), beta=0.9)
    assert tp.dtype == array_to_tensor(p).dtype
    wp, wu = jsngm_ref.sngm_update_ref(jnp.asarray(p), jnp.asarray(g),
                                       jnp.asarray(u), inv, lr, beta=0.9)
    assert _bitwise(wu, tu)
    # JAX's oracle keeps fp32 params for a bf16 leaf; the port rounds them
    assert _bitwise(np.asarray(wp).astype(DTYPES[dtype]), tp)
    ip, iu = jsngm_k.fused_sngm_update(jnp.asarray(p), jnp.asarray(g),
                                       jnp.asarray(u), jnp.asarray(inv),
                                       jnp.asarray(lr), beta=0.9,
                                       interpret=True)
    assert _rel(iu, tu) <= 2e-6
    assert _rel(np.asarray(ip).astype(DTYPES[dtype]), tp) <= (
        2e-6 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("wd", [0.0, 1e-4])
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_lars_matches_jax(dtype, n, wd):
    w, g, v = _leaf(n, dtype, seed=n + 1)
    tw, tg = array_to_tensor(w), array_to_tensor(g)
    for x, tx in ((w, tw), (g, tg)):
        rows = lars_ops.lars_sqnorm(tx)
        assert rows.shape == (max(1, -(-n // 1024)),)
        got = tmt._fold_sum(rows)
        assert _bitwise(got, tmt.leaf_sumsq(tx))
        assert _rel(jlars_k._sqnorm(jnp.asarray(x), True), got) <= 5e-6
    lr_local = np.float32(0.37 * 0.0021)
    nw, nv = tw.clone(), torch.from_numpy(v.copy())
    lars_ops.fused_lars_update(nw, tg, nv, torch.tensor(lr_local), beta=0.9, wd=wd)
    # the JAX kernel body's expression, on the same lr*local
    jv = 0.9 * jnp.asarray(v) + lr_local * (jnp.asarray(g).astype(jnp.float32)
                                            + wd * jnp.asarray(w))
    assert _bitwise(jv, nv)
    assert _bitwise((jnp.asarray(w) - jv).astype(w.dtype), nw)
    assert nw.dtype == tw.dtype
    # the whole JAX per-tensor step (2 norm launches + update, interpret)
    lr = np.float32(0.37)
    kw = dict(beta=0.9, wd=wd, trust=0.001, eps=1e-12)
    ew, ev = jlars_ops.lars_update(jnp.asarray(w), jnp.asarray(g),
                                   jnp.asarray(v), jnp.asarray(lr), **kw)
    pw, pv = tw.clone(), torch.from_numpy(v.copy())
    lars_ops.lars_update(pw, tg, pv, torch.tensor(lr), **kw)
    assert _rel(ev, pv) <= 2e-6
    assert _rel(np.asarray(ew).astype(w.dtype), pw) <= (
        2e-6 if dtype == "float32" else 1e-2)


def test_lars_sqnorm_of_an_empty_leaf_is_one_zero_row():
    rows = lars_ops.lars_sqnorm(torch.zeros(0))
    assert rows.shape == (1,) and float(rows[0]) == 0.0


def test_wrappers_on_cpu_run_plain_versions_without_launching():
    p, g, u = (array_to_tensor(x) for x in _leaf(1025, "float32", 0))
    reset_launches()
    sngm_ops.fused_sngm_update(p, g, u, torch.tensor(0.5), torch.tensor(0.1),
                               beta=0.9)
    lars_ops.lars_update(p, g, u, torch.tensor(0.1), beta=0.9, wd=1e-4)
    assert all(launch_counts()[k] == 0 for k in
               ("fused_sngm_update", "lars_sqnorm", "lars_update"))


@pytest.mark.parametrize("bad", ["dtype", "shape", "stride"])
def test_leaf_checks_reject_what_the_kernels_do_not_take(bad):
    like = torch.zeros(64)
    x = {"dtype": torch.zeros(64, dtype=torch.float16),
         "shape": torch.zeros(65),
         "stride": torch.zeros(128)[::2]}[bad]
    with pytest.raises((TypeError, ValueError)):
        sngm_ops.check_leaf("x", x, (torch.float32, torch.bfloat16),
                            like if bad != "stride" else x)


# ---------------------------------------------------------------------------
# optimizer steps
# ---------------------------------------------------------------------------

def _tree(seed, dtype="float32", empty_leaf=True):
    r = np.random.RandomState(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()
                    if empty_leaf or k != "z"}
        return np.asarray(r.randn(*node), np.float32).astype(DTYPES[dtype])
    return walk(SHAPES)


OPT_KWARGS = {"sngm": {"beta": 0.9}, "sngd": {}, "lars": {"beta": 0.9}}


def _run_port(name, fused, dtype, steps=3, empty_leaf=True):
    opt = topt.make_optimizer(name, tpoly(0.5, 10), weight_decay=1e-4,
                              fused=fused, **OPT_KWARGS[name])
    ts = opt.init_state(from_numpy_tree(_tree(0, dtype, empty_leaf)))
    stats = []
    for t in range(steps):
        ts, st = opt.step_state(from_numpy_tree(_tree(t + 1, dtype, empty_leaf)), ts)
        stats.append({k: float(v) for k, v in st.items()})
    return ts, stats


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(OPT_KWARGS))
def test_per_leaf_equals_plain_bitwise(name, dtype):
    a, sa = _run_port(name, None, dtype)
    b, sb = _run_port(name, "per_leaf", dtype)
    assert isinstance(b.opt_state, topt.OptState) and b.params is not None
    assert sa == sb
    for k in a.params:
        assert a.params[k].dtype == b.params[k].dtype, k
        assert _bitwise(a.params[k], b.params[k]), k
        assert _bitwise(a.opt_state.momentum[k], b.opt_state.momentum[k]), k


def _run_jax(name, steps=3, dtype="float32"):
    opt = getattr(jopt, name)(jpoly(0.5, 10), weight_decay=1e-4,
                              fused="per_leaf", **OPT_KWARGS[name])
    params = jax.tree.map(jnp.asarray, _tree(0, dtype, empty_leaf=False))
    state = opt.init(params)
    stats = []
    for t in range(steps):
        grads = jax.tree.map(jnp.asarray, _tree(t + 1, dtype, empty_leaf=False))
        params, state, st = opt.step(grads, state, params)
        stats.append({k: float(v) for k, v in st.items()})
    return (from_numpy_tree(jax.tree.map(np.asarray, params)),
            from_numpy_tree(jax.tree.map(np.asarray, state.momentum)), stats)


@pytest.mark.parametrize("name", sorted(OPT_KWARGS))
def test_per_leaf_matches_jax_per_leaf(name):
    jp, ju, jstats = _run_jax(name)
    ts, tstats = _run_port(name, "per_leaf", "float32", empty_leaf=False)
    assert set(jp) == set(ts.params)
    for k in jp:
        assert np.abs(_f32(jp[k]) - _f32(ts.params[k])).max(initial=0.0) <= 1e-6, k
        assert _rel(ju[k], ts.opt_state.momentum[k]) <= 2e-6, k
    for w, g in zip(jstats, tstats):
        assert set(w) == set(g)
        for k in w:
            assert abs(w[k] - g[k]) <= 1e-6 * abs(w[k]), (k, w[k], g[k])


def test_bf16_per_leaf_sngm_is_jax_output_rounded_bitwise():
    jp, ju, _ = _run_jax("sngm", steps=1, dtype="bfloat16")
    ts, _ = _run_port("sngm", "per_leaf", "bfloat16", steps=1, empty_leaf=False)
    for k in jp:
        assert jp[k].dtype == torch.float32          # the reference's output
        assert ts.params[k].dtype == torch.bfloat16  # the port keeps the leaf's
        assert torch.equal(jp[k].to(torch.bfloat16).view(torch.int16),
                           ts.params[k].view(torch.int16)), k
        assert _bitwise(ju[k], ts.opt_state.momentum[k]), k


@pytest.mark.parametrize("name,launches", [("sngm", 1), ("sngd", 1), ("lars", 3)])
def test_per_leaf_launch_counts_per_step(monkeypatch, name, launches):
    calls = []

    def counting(mod, fn_name):
        fn = getattr(mod, fn_name)

        def wrapped(*a, **k):
            calls.append(fn_name)
            return fn(*a, **k)
        monkeypatch.setattr(mod, fn_name, wrapped)
    counting(sngm_ops, "fused_sngm_update")
    counting(lars_ops, "lars_sqnorm")
    counting(lars_ops, "fused_lars_update")
    n_leaves = len(from_numpy_tree(_tree(0)))
    _run_port(name, "per_leaf", "float32", steps=2)
    assert len(calls) == 2 * launches * n_leaves, calls
    if name == "lars":
        assert calls.count("lars_sqnorm") == 2 * 2 * n_leaves
    calls.clear()
    _run_port(name, None, "float32", steps=1)
    assert calls == []


JS, TS = jpoly(0.5, 10), tpoly(0.5, 10)
# each refusal as (JAX package call, port call)
REFUSALS = {
    "kind_msgd": (lambda: jopt._kind_optimizer("msgd", JS, beta=0.9,
                                               fused_mode="per_leaf"),
                  lambda: topt._kind_optimizer("msgd", TS, beta=0.9,
                                               fused="per_leaf")),
    "clip": (lambda: jopt._kind_optimizer("sngm_global", JS, beta=0.9, clip=1.0,
                                          fused_mode="per_leaf"),
             lambda: topt._kind_optimizer("sngm_global", TS, beta=0.9, clip=1.0,
                                          fused="per_leaf")),
    "nesterov": (lambda: jopt.sngm(JS, nesterov=True, fused="per_leaf"),
                 lambda: topt.sngm(TS, nesterov=True, fused="per_leaf")),
    "per_tensor": (lambda: jopt.sngm(JS, norm_mode="per_tensor", fused="per_leaf"),
                   lambda: topt.sngm(TS, norm_mode="per_tensor", fused="per_leaf")),
    "msgd": (lambda: jopt.msgd(JS, fused="per_leaf"),
             lambda: topt.msgd(TS, fused="per_leaf")),
    "unknown_mode": (lambda: jopt.lars(JS, fused="bogus"),
                     lambda: topt.lars(TS, fused="bogus")),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_per_leaf_refusals_carry_the_jax_messages(case):
    jax_call, port_call = REFUSALS[case]
    with pytest.raises(ValueError) as want:
        jax_call()
    with pytest.raises(ValueError) as got:
        port_call()
    assert str(got.value) == str(want.value)


def test_per_leaf_updates_the_state_it_is_given_in_place():
    opt = topt.sngm(tpoly(0.5, 10), weight_decay=1e-4, fused="per_leaf")
    ts = opt.init_state(from_numpy_tree(_tree(0)))
    ptrs = {k: v.data_ptr() for k, v in ts.params.items()}
    new, _ = opt.step_state(from_numpy_tree(_tree(1)), ts)
    assert {k: v.data_ptr() for k, v in new.params.items()} == ptrs
    # a resident state fed to the per-leaf path steps its buffer views
    res = topt.sngm(tpoly(0.5, 10), fused="multi_tensor").init_state(
        from_numpy_tree(_tree(0)))
    out, _ = opt.step_state(from_numpy_tree(_tree(1)), res)
    assert isinstance(out.opt_state, topt.OptState)
    assert all(out.params[k].data_ptr() == v.data_ptr()
               for k, v in res.opt_state.params.items() if v.numel())


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _launch(capsys, *flags):
    losses = launcher.main(["--arch", "gemma-2b", "--reduced", "--device",
                            "cpu", "--steps", "2", "--batch", "4", "--seq",
                            "32", "--log-every", "1", *flags])
    lines = capsys.readouterr().out.splitlines()
    return losses, [l.split(" (")[0] for l in lines if l.startswith("  step")]


def test_launcher_sngm_per_leaf_equals_none(capsys):
    _, none = _launch(capsys, "--fused", "none")
    losses, per_leaf = _launch(capsys, "--fused", "per_leaf")
    assert len(per_leaf) == 2 and per_leaf == none
    assert all(np.isfinite(losses))


def test_launcher_lars_per_leaf_runs_and_equals_none(capsys):
    losses, per_leaf = _launch(capsys, "--optimizer", "lars", "--fused", "per_leaf")
    assert len(losses) == 2 and all(np.isfinite(losses))
    _, none = _launch(capsys, "--optimizer", "lars", "--fused", "none")
    assert per_leaf == none


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _cuda(*xs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode "
                    "(chip_smoke.py runs them on the card)")
    return [array_to_tensor(x).cuda() for x in xs]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_fused_sngm_update_matches_plain_bitwise(dtype):
    for n in LENGTHS:
        p, g, u = _cuda(*_leaf(n, dtype, seed=n))
        inv = torch.tensor(0.0123, device="cuda")
        wp, wu = sngm_ref.sngm_update_ref(p, g, u, inv, torch.tensor(0.37), beta=0.9)
        kp, ku = p.clone(), u.clone()
        sngm_ops.fused_sngm_update(kp, g, ku, inv, torch.tensor(0.37), beta=0.9)
        torch.cuda.synchronize()
        assert _bitwise(wp, kp) and _bitwise(wu, ku), n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_lars_kernels_match_plain_bitwise(dtype):
    for n in LENGTHS:
        w, g, v = _cuda(*_leaf(n, dtype, seed=n + 1))
        assert _bitwise(lars_ref.lars_sqnorm_ref(w), lars_ops.lars_sqnorm(w))
        a = torch.tensor(0.37 * 0.0021, device="cuda")
        for wd in (0.0, 1e-4):
            ww, wv = lars_ref.lars_update_ref(w, g, v, a, beta=0.9, wd=wd)
            kw, kv = w.clone(), v.clone()
            lars_ops.fused_lars_update(kw, g, kv, a, beta=0.9, wd=wd)
            torch.cuda.synchronize()
            assert _bitwise(ww, kw) and _bitwise(wv, kv), (n, wd)
