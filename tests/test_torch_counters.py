"""The port's engine counters (``repro_torch.tracker.counters``) against
the JAX package's (``repro.tracker.counters``), and the kernel call
count they read (``repro_torch.kernels.count_kernel_calls``).

The JAX counts are taken when a step is traced; the port runs one step
on clones and counts wrapper calls, which a CPU step makes as a step on
the card launches them.  Every number is held **equal** to the JAX
package's: ``engine_counters`` (launches, packed bytes, live param
bytes) and ``plan_launches_per_step``, on the Fig-1 convnet's tree and
on a mixed fp32/bf16 tree (2 dtype buckets), for sngm, sngd, msgd,
lars and lamb on the engine, nesterov sngm, a clip -> sngm chain, and
sngm and lars per leaf.  The caller's state and params keep their bits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import ml_dtypes

from repro.core import optim as jopt
from repro.core import transform as jT
from repro.core.schedules import poly_power as jpoly
from repro.models.convnet import init_convnet as jax_init_convnet
from repro.tracker import counters as jc
from repro_torch.convert import from_numpy_tree
from repro_torch.core import optim as topt
from repro_torch.core import transform as tT
from repro_torch.core.multi_tensor import FlatGrads, zeros_flats
from repro_torch.core.schedules import poly_power as tpoly
from repro_torch.kernels import CALLS, count_kernel_calls, launch_counts
from repro_torch.tracker import counters as tc

WD = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _convnet_tree():
    return jax.tree.map(np.asarray, jax_init_convnet(0, width=8))


def _mixed_tree():
    """fp32 and bf16 leaves, nested: two dtype buckets."""
    r = np.random.RandomState(0)
    f32 = lambda *s: r.randn(*s).astype(np.float32)              # noqa: E731
    bf16 = lambda *s: r.randn(*s).astype(np.float32).astype(ml_dtypes.bfloat16)  # noqa: E731
    return {"a": f32(300), "b": bf16(40, 30),
            "c": {"d": f32(7, 5), "e": bf16(129), "f": f32(1100)}}


TREES = {"convnet": _convnet_tree, "mixed": _mixed_tree}


def _clip_sngm(M, S, fused):
    tx = M.chain(M.clip_by_global_norm(1.0), M.add_decayed_weights(WD),
                 M.normalize_by_global_norm(), M.trace(0.9),
                 M.scale_by_schedule(S(0.1, 10)))
    return M.compile_chain(tx, fused=fused)


# name -> (build(package optim, transform, schedule, fused), fused mode,
# launches per bucket, or (None, n): per leaf, n a leaf)
CASES = {
    "sngm": (lambda O, M, S, f: O.sngm(S(0.1, 10), weight_decay=WD, fused=f),
             "multi_tensor", 2),
    "sngd": (lambda O, M, S, f: O.sngd(S(0.1, 10), weight_decay=WD, fused=f),
             "multi_tensor", 2),
    "msgd": (lambda O, M, S, f: O.msgd(S(0.1, 10), weight_decay=WD, fused=f),
             "multi_tensor", 2),
    "lars": (lambda O, M, S, f: O.lars(S(0.1, 10), weight_decay=WD, fused=f),
             "multi_tensor", 3),
    "lamb": (lambda O, M, S, f: O.lamb(S(0.01, 10), weight_decay=WD, fused=f),
             "multi_tensor", 2),
    "sngm_nesterov": (lambda O, M, S, f: O.sngm(S(0.1, 10), nesterov=True,
                                               fused=f), "multi_tensor", 2),
    "clip_sngm": (lambda O, M, S, f: _clip_sngm(M, S, f), "multi_tensor", 3),
    "sngm_per_leaf": (lambda O, M, S, f: O.sngm(S(0.1, 10), fused=f),
                      "per_leaf", (None, 1)),
    "lars_per_leaf": (lambda O, M, S, f: O.lars(S(0.1, 10), fused=f),
                      "per_leaf", (None, 3)),
}


def _pair(case):
    build, fused, _ = CASES[case]
    return (build(jopt, jT, jpoly, fused), build(topt, tT, tpoly, fused))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("tree", sorted(TREES))
def test_engine_counters_equal_the_jax_counters(tree, case):
    jp = TREES[tree]()
    tp = from_numpy_tree(jp)
    jo, to = _pair(case)
    want = jc.engine_counters(jo, jax.tree.map(jnp.asarray, jp))
    got = tc.engine_counters(to, tp)
    assert got == want
    assert tc.plan_launches_per_step(to, tp) == jc.plan_launches_per_step(
        jo, jax.tree.map(jnp.asarray, jp))
    # the numbers themselves: O(1) a bucket on the engine, O(n) per leaf
    n_buckets = len({str(v.dtype) for v in tp.values()})
    per = CASES[case][2]
    if isinstance(per, tuple):
        assert got["launches_per_step"] == per[1] * len(tp)
        assert got["packed_bytes_per_step"] == 0
        assert got["param_bytes_live"] == sum(v.numel() * v.element_size()
                                              for v in tp.values())
    else:
        assert got["launches_per_step"] == per * n_buckets
        assert tc.plan_launches_per_step(to, tp) == per * n_buckets
        # resident: the gradients are the only bytes packed (twice under
        # a clip round: the raw ones for their norm, then the clipped
        # ones), and the flat buffers (params in their own dtype) the only
        # live param copy
        packs = 2 if case == "clip_sngm" else 1
        assert got["packed_bytes_per_step"] == packs * got["param_bytes_live"]


def _bits(x):
    if isinstance(x, torch.Tensor):
        return [x.view(torch.int16 if x.element_size() == 2 else torch.int32)
                .clone()]
    if isinstance(x, dict):
        return [b for k in sorted(x) for b in _bits(x[k])]
    if isinstance(x, (tuple, list)):
        return [b for v in x for b in _bits(v)]
    if hasattr(x, "__dataclass_fields__"):
        return [b for k in x.__dataclass_fields__ for b in _bits(getattr(x, k))]
    return []


@pytest.mark.parametrize("case", ["sngm", "lamb", "clip_sngm", "lars_per_leaf"])
def test_counters_leave_the_callers_state_and_params_untouched(case):
    tp = from_numpy_tree(_mixed_tree())
    _, to = _pair(case)
    ts = to.init_state({k: v.clone() for k, v in tp.items()})
    grads = {k: torch.full_like(v, 0.5) for k, v in tp.items()}
    before = _bits((ts.params, ts.opt_state, grads, tp))
    assert tc.launches_per_step(to, grads, ts.opt_state, ts.params) > 0
    tc.packed_bytes_per_step(to, grads, ts.opt_state, ts.params)
    tc.engine_counters(to, tp)
    after = _bits((ts.params, ts.opt_state, grads, tp))
    assert len(before) == len(after)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    # and the state still steps as a fresh one does
    fresh = to.init_state({k: v.clone() for k, v in tp.items()})
    s1, _ = to.step_state(grads, ts)
    s2, _ = to.step_state({k: g.clone() for k, g in grads.items()}, fresh)
    assert all(torch.equal(a, b) for a, b in zip(_bits(s1.params_view),
                                                  _bits(s2.params_view)))


def test_resident_step_fed_flat_grads_packs_nothing():
    tp = from_numpy_tree(_mixed_tree())
    _, to = _pair("sngm")
    ts = to.init_state(tp)
    layout = ts.opt_state.layout
    grads = FlatGrads(tuple(f.fill_(0.25) for f in zeros_flats(layout)), layout)
    assert tc.packed_bytes_per_step(to, grads, ts.opt_state, None) == 0
    assert tc.launches_per_step(to, grads, ts.opt_state, None) == 4
    assert tc.param_bytes_live(ts) == sum(f.numel() * f.element_size()
                                          for f in ts.opt_state.p_flats)


def test_count_kernel_calls_counts_calls_on_the_cpu_and_launches_none():
    from repro_torch.kernels.multi_tensor import ops
    x = torch.ones(2 * ops.TILE)
    before = launch_counts()
    calls0 = dict(CALLS)
    with count_kernel_calls() as c:
        ops.chunk_sumsq(x)
        ops.chunk_sumsq(x)
    assert c["launches"] == 2 and c["calls"]["chunk_sumsq"] == 2
    assert sum(c["calls"].values()) == 2
    assert CALLS["chunk_sumsq"] == calls0["chunk_sumsq"] + 2
    assert launch_counts() == before          # the CPU launches nothing
    assert set(CALLS) == set(before)
