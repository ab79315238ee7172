"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``: routing, capacity dispatch, the dense
oracle and gradients.

Inputs and weights come from numpy with a seed (the MoE weights of
``moe_defs`` drawn at 1/sqrt(d) and 1/sqrt(d_expert), the router at
0.02 as its def says); the JAX side runs its mesh-free ``moe_apply``.
Bounds, and why:

  * ``route``: ids equal (ties included: a zero router ties every
    expert, and both packages keep the lowest expert id first); weights
    within 1e-6 of their max and the aux loss within 1e-6 relative
    (fp32 softmax, summed in other orders);
  * capacity dispatch: the ``keep`` mask and the capacity positions
    equal, with drops (capacity factor 0.5, and the all-tied router)
    and without (8.0); the output within 1e-5 of its max and the aux
    loss within 1e-6 relative (fp32; the expert matmuls sum in other
    orders);
  * gradients of ``sum(y**2) + aux`` for every weight and the input,
    against ``jax.grad``: 2e-5 of each leaf's largest magnitude;
  * the port's capacity dispatch against its dense oracle ``moe_ref``
    with nothing dropped: 1e-5 of the max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import MoEConfig as JMoE
from repro.configs import ModelConfig as JModel
from repro.models import CPU_RUNTIME as JAX_RT
from repro.models import moe as jmoe
from repro_torch.configs.base import MoEConfig, ModelConfig
from repro_torch.convert import from_numpy_tree
from repro_torch.models import moe as tmoe
from repro_torch.models.param import flatten_defs

E, K, D, F_EXPERT, T_B, T_S = 8, 2, 64, 96, 4, 16


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(router_mode="softmax_topk", cf=8.0, n_shared=0):
    kw = dict(name="t", family="moe", n_layers=2, d_model=D, n_heads=4,
              n_kv_heads=4, d_ff=128, vocab_size=128, compute_dtype="float32")
    mk = dict(n_experts=E, top_k=K, d_expert=F_EXPERT, n_shared=n_shared,
              capacity_factor=cf, router_mode=router_mode)
    return (JModel(moe=JMoE(**mk), **kw), ModelConfig(moe=MoEConfig(**mk), **kw))


def _weights(cfg, seed=0, zero_router=False):
    """numpy tree of ``moe_defs``: every matrix at 1/sqrt(its contracted
    dim), the router at its def's 0.02."""
    r = np.random.RandomState(seed)

    def draw(shape, fan):
        return np.asarray(r.randn(*shape) / np.sqrt(fan), np.float32)
    w = {"router": np.asarray(r.randn(D, E) * 0.02, np.float32),
         "wg": draw((E, D, F_EXPERT), D), "wu": draw((E, D, F_EXPERT), D),
         "wd": draw((E, F_EXPERT, D), F_EXPERT)}
    if zero_router:
        w["router"] = np.zeros_like(w["router"])
    if cfg.moe.n_shared:
        f = cfg.moe.n_shared * F_EXPERT
        w["shared"] = {"wg": draw((D, f), D), "wu": draw((D, f), D),
                       "wd": draw((f, D), f)}
    return w


def _x(seed=1):
    return np.asarray(np.random.RandomState(seed).randn(T_B, T_S, D), np.float32)


def _rel(ref, got):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return np.max(np.abs(ref - got)) / max(1e-30, np.max(np.abs(ref)))


def _jax_plan(w, x, cfg):
    """The JAX body's routing and capacity positions, op for op."""
    xf = jnp.asarray(x.reshape(-1, D))
    logits = xf.astype(jnp.float32) @ jnp.asarray(w["router"])
    weights, ids, aux = jmoe.route(logits, cfg)
    T = xf.shape[0]
    cap = max(jmoe.MIN_CAPACITY, int(np.ceil(T * cfg.moe.top_k / cfg.moe.n_experts
                                             * cfg.moe.capacity_factor)))
    pos, keep = jmoe._positions(ids.reshape(-1), cfg.moe.n_experts, cap)
    return weights, ids, aux, pos, keep, cap


def test_moe_defs_match_jax():
    for n_shared in (0, 1):
        jc, tc = _cfgs(n_shared=n_shared)
        jd = jmoe.moe_defs(jc)
        flat = jax.tree_util.tree_flatten_with_path(
            jd, is_leaf=lambda d: hasattr(d, "axes"))[0]
        jflat = {".".join(str(k.key) for k in path): d for path, d in flat}
        tflat = flatten_defs(tmoe.moe_defs(tc))
        assert sorted(jflat) == sorted(tflat)
        for k, d in jflat.items():
            e = tflat[k]
            assert (d.shape, d.axes, d.init, d.scale) == (e.shape, e.axes, e.init, e.scale), k


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["softmax_topk", "topk_softmax"])
def test_route_matches_jax(mode):
    jc, tc = _cfgs(mode)
    logits = np.asarray(np.random.RandomState(2).randn(64, E), np.float32)
    jw, jids, jaux = jmoe.route(jnp.asarray(logits), jc)
    tw, tids, taux = tmoe.route(torch.from_numpy(logits), tc)
    assert np.array_equal(np.asarray(jids), tids.numpy())
    assert _rel(jw, tw) <= 1e-6
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))


@pytest.mark.parametrize("mode", ["softmax_topk", "topk_softmax"])
@pytest.mark.parametrize("logits", ["zero", "quantized"])
def test_route_ties_keep_the_lowest_expert_first(mode, logits):
    """A zero router ties every expert (ids 0..k-1 in every row, aux 1);
    logits quantized to four values tie at every rank."""
    jc, tc = _cfgs(mode)
    if logits == "zero":
        lg = np.zeros((64, E), np.float32)
    else:
        lg = np.random.RandomState(3).randint(0, 4, (64, E)).astype(np.float32)
    jw, jids, jaux = jmoe.route(jnp.asarray(lg), jc)
    tw, tids, taux = tmoe.route(torch.from_numpy(lg), tc)
    assert np.array_equal(np.asarray(jids), tids.numpy())
    assert _rel(jw, tw) <= 1e-6
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    if logits == "zero":
        assert (tids.numpy() == np.arange(K)).all() and abs(float(taux) - 1) < 1e-6


# ---------------------------------------------------------------------------
# capacity dispatch
# ---------------------------------------------------------------------------

CASES = [(cf, n_shared, mode) for cf in (8.0, 0.5) for n_shared in (0, 1)
         for mode in ("softmax_topk", "topk_softmax")]


@pytest.mark.parametrize("cf,n_shared,mode", CASES,
                         ids=[f"cf{cf}-shared{s}-{m}" for cf, s, m in CASES])
def test_moe_apply_matches_jax(cf, n_shared, mode):
    jc, tc = _cfgs(mode, cf, n_shared)
    w, x = _weights(tc), _x()
    tw = from_numpy_tree(w)
    jy, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, w), jnp.asarray(x), jc, JAX_RT)
    ty, taux = tmoe.moe_apply(tw, torch.from_numpy(x), tc)
    _, jids, _, jpos, jkeep, jcap = _jax_plan(w, x, jc)
    _, tids, _, tpos, tkeep, tcap = tmoe.dispatch_plan(
        tw["router"], torch.from_numpy(x.reshape(-1, D)), tc)
    assert tcap == jcap
    assert np.array_equal(np.asarray(jids), tids.numpy())
    assert np.array_equal(np.asarray(jkeep), tkeep.numpy())
    assert np.array_equal(np.asarray(jpos), tpos.numpy())
    assert bool(tkeep.all()) == (cf == 8.0)             # 0.5 drops, 8.0 does not
    assert tuple(ty.shape) == (T_B, T_S, D)
    assert _rel(jy, ty) <= 1e-5
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))


@pytest.mark.parametrize("mode", ["softmax_topk", "topk_softmax"])
def test_tied_router_drops_the_assignments_jax_drops(mode):
    """A zero router sends every token to experts 0..k-1: capacity
    (16 of 128 assignments an expert at factor 1.0) keeps the first
    tokens in token order, as in the JAX package."""
    jc, tc = _cfgs(mode, cf=1.0)
    w, x = _weights(tc, zero_router=True), _x()
    tw = from_numpy_tree(w)
    jy, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, w), jnp.asarray(x), jc, JAX_RT)
    ty, taux = tmoe.moe_apply(tw, torch.from_numpy(x), tc)
    _, _, _, _, jkeep, cap = _jax_plan(w, x, jc)
    _, tids, _, _, tkeep, _ = tmoe.dispatch_plan(
        tw["router"], torch.from_numpy(x.reshape(-1, D)), tc)
    assert np.array_equal(np.asarray(jkeep), tkeep.numpy())
    assert int(tkeep.sum()) == K * cap                  # each of k experts full
    assert _rel(jy, ty) <= 1e-5
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))


@pytest.mark.parametrize("n_shared", [0, 1])
def test_dispatch_equals_the_dense_oracle_without_drops(n_shared):
    jc, tc = _cfgs(cf=8.0, n_shared=n_shared)
    w, x = _weights(tc), _x()
    tw = from_numpy_tree(w)
    ty, taux = tmoe.moe_apply(tw, torch.from_numpy(x), tc)
    ry, raux = tmoe.moe_ref(tw, torch.from_numpy(x), tc)
    jy, jaux = jmoe.moe_ref(jax.tree.map(jnp.asarray, w), jnp.asarray(x), jc)
    assert _rel(ry.numpy(), ty) <= 1e-5 and _rel(jy, ry) <= 1e-5
    assert float(taux) == float(raux)
    assert abs(float(raux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    # with drops the dispatch and the oracle part
    _, tc_drop = _cfgs(cf=0.5, n_shared=n_shared)
    yd, _ = tmoe.moe_apply(tw, torch.from_numpy(x), tc_drop)
    assert _rel(ry.numpy(), yd) > 1e-3


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_moe_gradients_match_jax(cf):
    jc, tc = _cfgs(cf=cf, n_shared=1)
    w, x = _weights(tc), _x()

    def jloss(wt, xx):
        y, aux = jmoe.moe_apply(wt, xx, jc, JAX_RT)
        return jnp.sum(y ** 2) + aux
    jg_w, jg_x = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, w),
                                                  jnp.asarray(x))
    tw = {k: v.requires_grad_() for k, v in from_numpy_tree(w).items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = tmoe.moe_apply(tw, tx, tc)
    (torch.sum(y ** 2) + aux).backward()
    jflat = from_numpy_tree(jax.tree.map(np.asarray, jg_w))
    assert sorted(jflat) == sorted(tw)
    for k, g in jflat.items():
        assert _rel(g.numpy(), tw[k].grad) <= 2e-5, k
    assert float(jflat["router"].abs().max()) > 0       # the router learns
    assert _rel(jg_x, tx.grad) <= 2e-5
