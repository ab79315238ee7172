"""The jamba hybrid in the port (jamba-1.5-large-398b: Mamba2 layers, one
GQA attention layer and top-2 MoE FFNs in one period, every leaf stored
in bf16) against the JAX package: the parameter tree, the bf16 leaves'
casts, ``forward`` in its three modes, the loss with its MoE aux loss
and every gradient, SNGM on the engine, the dense and paged caches, the
scheduler, ``greedy_generate`` and the ``ContinuousBatcher``, the
long-context ring beside the Mamba state, and both launchers.

Model: the smoke variant of jamba-1.5-large-398b, 8 layers in 2 periods
of 4 (mamba/dense, mamba/moe, attn/dense, mamba/moe), d_model 256, 4
experts, top-2, d_state 16, headdim 32, chunk 16, bf16 params.  Weights
are the JAX package's ``materialize(model_defs(cfg), PRNGKey(0))``
with every matmul weight and the conv redrawn from numpy at 1/sqrt(its
true fan-in) (``_params``), carried across by ``repro_torch.convert``;
the launchers draw their own from PRNGKey(0).  At the reference init
the stack is ill-conditioned: the reference reads a stacked leaf's
fan-in from its layer axis (2 here), so the residual stream grows to
~500 and one bf16 rounding at the attention layer grows to 0.22 of the
largest hidden state over the 8 layers
(``test_reference_init_is_ill_conditioned_in_bf16``).  Tokens come from
numpy with a seed.  Bounds, and why:

  * forward logits, train-mode hidden states and the prefill and decode
    caches: fp32 5e-5 and bf16 5e-2 of the largest magnitude, the model
    tests' bounds; the aux loss 1e-6 relative (fp32; 1e-2 in bf16);
  * decode against a teacher-forced prefill (the port alone): the
    reference's own ``atol`` 3e-3, ``rtol`` 1e-2 (``tests/test_decode.py``);
    the rotated ring of the long-context variant 5e-5 of max|logits|
    (fp32);
  * ``loss_fn`` and every gradient: the loss 2e-5 relative, each
    gradient within 2e-5 of its leaf's largest magnitude plus one bf16
    step of the value (2^-7 max(|g_jax|, |g_port|)): the gradients of
    bf16-stored leaves are rounded to bf16, and fp32 sums in other
    orders can round them a step apart; with remat they are bitwise
    those without;
  * SNGM on the engine against ``fused=None``: bitwise, 3 steps, 2
    launches a step, one bf16 bucket, fp32 momentum; against the JAX
    package's ``fused=None`` optimizer on the same gradients: momentum
    within 2e-6 of its largest magnitude, the bf16 params within 2e-6
    of the max plus one bf16 step of the value, the stats 1e-6 relative;
  * the paged scheduler, ``greedy_generate``, the ``ContinuousBatcher``
    and both launchers: the JAX package's tokens (fp32 compute);
  * paged against dense decode: bitwise.
"""
import contextlib
import dataclasses
import io
import re
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.launch.serve as jax_serve_launcher
import repro.launch.train as jax_train_launcher
from repro import configs as jcfg
from repro.core import optim as jopt
from repro.core import schedules as jsched
from repro.launch.serve import ContinuousBatcher as JaxBatcher
from repro.launch.serve import Request as JaxRequest
from repro.models import CPU_RUNTIME as JAX_RT
from repro.models import forward as jax_forward
from repro.models import model_defs as jax_model_defs
from repro.models.param import count as jax_count
from repro.models.param import is_def, materialize as jax_materialize
from repro.serving import engine as jeng
from repro.serving.scheduler import PagedScheduler as JaxScheduler
from repro.serving.scheduler import ServeRequest as JaxServeRequest
from repro.training import step as jstep
from repro_torch import configs as tcfg
from repro_torch import kernels, prng
from repro_torch.configs.base import LayerSpec, layer_pattern
from repro_torch.convert import from_numpy_tree
from repro_torch.core import optim as topt
from repro_torch.core import schedules as tsched
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import (CPU_RUNTIME, Runtime, cast_for_compute, count,
                                forward, materialize, model_defs)
from repro_torch.models.param import flatten_defs
from repro_torch.models.transformer import MATMUL_LEAVES
from repro_torch.serving import engine as teng
from repro_torch.serving import paged_cache as tpc
from repro_torch.serving.scheduler import PagedScheduler, ServeRequest
from repro_torch.training import step as tstep

ARCH = "jamba-1.5-large-398b"
CPU = torch.device("cpu")
REL = {"float32": 5e-5, "bfloat16": 5e-2}
AUX_REL = {"float32": 1e-6, "bfloat16": 1e-2}
BF16_STEP = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(dtype="float32", long_context=False):
    out = []
    for mod in (jcfg, tcfg):
        c = mod.smoke_variant(mod.ARCHS[ARCH])
        if long_context:
            c = c.for_long_context()
        out.append(dataclasses.replace(c, compute_dtype=dtype))
    return out


def _fan_in(parent, name, shape):
    """True fan-in of a stacked (layer axis first) matmul leaf or conv."""
    if name == "wo":                         # (n_p, H, hd, d)
        return int(np.prod(shape[1:-1]))
    if parent == "moe":                      # experts (n_p, E, in, out)
        return shape[2]
    return shape[1]                          # (n_p, in, ...); conv (n_p, W, C)


REDRAW = ("wq", "wk", "wv", "wo", "wg", "wu", "wd", "wz", "wx", "wB", "wC",
          "wdt", "out_proj", "conv_w")
_PARAMS = {}


def _params(redraw=True):
    """The JAX package's smoke params as a numpy tree (bf16 leaves as
    ``ml_dtypes.bfloat16``); with ``redraw`` every matmul weight and the
    conv redrawn from numpy at 1/sqrt(its true fan-in), stored bf16."""
    if redraw not in _PARAMS:
        jc, _ = _cfgs()
        tree = jax.tree.map(np.asarray, jax_materialize(jax_model_defs(jc),
                                                        jax.random.PRNGKey(0)))
        if redraw:
            r = np.random.RandomState(0)

            def walk(d, parent):
                for k, v in d.items():
                    if isinstance(v, dict):
                        walk(v, k)
                    elif k in REDRAW:
                        fan = _fan_in(parent, k, v.shape)
                        d[k] = (r.randn(*v.shape) / np.sqrt(fan)
                                ).astype(np.float32).astype(v.dtype)
            walk(tree["blocks"], "blocks")
        _PARAMS[redraw] = tree
    return _PARAMS[redraw]


def _tokens(vocab, B, S, seed):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(np.int32)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(ref, got):
    ref, got = _np32(ref), _np32(got)
    return float(np.abs(ref - got).max()) / max(float(np.abs(ref).max()), 1e-30)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _defs_flat_jax(cfg):
    flat = jax.tree_util.tree_flatten_with_path(jax_model_defs(cfg), is_leaf=is_def)[0]
    return {".".join(str(k.key) for k in path): d for path, d in flat}


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def test_full_width_tree_matches_jax_path_for_path():
    """135 leaves, 397,711,939,584 params, every leaf bf16.  The analytic
    ``param_count`` reads 974,592 fewer: the reference's ``_mamba_params``
    leaves out ``conv_b`` (63 Mamba layers x 16,640) and its attention
    layers count one d_model norm too many (9 x 8192)."""
    cfg = tcfg.ARCHS[ARCH]
    jflat = _defs_flat_jax(jcfg.ARCHS[ARCH])
    tflat = flatten_defs(model_defs(cfg))
    assert sorted(jflat) == sorted(tflat) and len(tflat) == 135
    for k, d in jflat.items():
        e = tflat[k]
        assert (d.shape, d.axes, d.init, d.scale) == (e.shape, e.axes, e.init, e.scale), k
        assert np.dtype(d.dtype).name == "bfloat16" and e.dtype == torch.bfloat16, k
    n = count(model_defs(cfg))
    assert n == jax_count(jax_model_defs(jcfg.ARCHS[ARCH])) == 397_711_939_584
    assert n - cfg.param_count() == 974_592 == 63 * 16_640 - 9 * 8192


def test_one_period_layout_and_the_card_cuts():
    """One period of 8 layers: L4 attention (attn_norm, attn), the rest
    Mamba (mixer_norm, mamba); even layers a dense FFN, odd ones MoE.
    The serving cut (one period, 4 experts, full widths) holds
    16,153,237,504 params in 135 leaves (30.09 GiB in bf16)."""
    cfg = tcfg.ARCHS[ARCH]
    _, period, n_periods = layer_pattern(cfg)
    assert n_periods == 9 and list(period) == [
        LayerSpec("attn" if i == 4 else "mamba", "moe" if i % 2 else "dense")
        for i in range(8)]
    blocks = model_defs(cfg)["blocks"]
    for i in range(8):
        want = ({"attn_norm", "attn"} if i == 4 else {"mixer_norm", "mamba"}) \
            | {"ffn_norm", "moe" if i % 2 else "ffn"}
        assert set(blocks[f"L{i}"]) == want, i
    cut = dataclasses.replace(cfg, n_layers=8, moe=dataclasses.replace(
        cfg.moe, n_experts=4))
    tflat = flatten_defs(model_defs(cut))
    assert len(tflat) == 135 and count(model_defs(cut)) == 16_153_237_504
    assert sorted(tflat) == sorted(_defs_flat_jax(dataclasses.replace(
        jcfg.ARCHS[ARCH], n_layers=8, moe=dataclasses.replace(
            jcfg.ARCHS[ARCH].moe, n_experts=4))))
    assert tflat["blocks.L1.moe.wg"].shape == (1, 4, 8192, 24576)
    assert tflat["blocks.L4.attn.wq"].shape == (1, 8192, 64, 128)
    assert tflat["blocks.L4.attn.wk"].shape == (1, 8192, 8, 128)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bf16_leaves_cast_at_use_and_load_model(dtype):
    """``cast_for_compute`` of the bf16 tree: the matmul weights and the
    conv in the compute dtype (an exact widening at fp32 compute), every
    other leaf (router, norm scales, A_log, D, dt_bias, embeddings) as
    stored, bf16.  ``load_model`` draws the same bits leaf by leaf."""
    _, tc = _cfgs(dtype)
    raw = materialize(model_defs(tc), prng.PRNGKey(0), CPU)
    assert {v.dtype for v in raw.values()} == {torch.bfloat16}
    cast = cast_for_compute(raw, tc)
    got, n = serve_launcher.load_model(tc, CPU_RUNTIME, seed=0)
    assert n == count(model_defs(tc)) and sorted(got) == sorted(cast) == sorted(raw)
    cdt = getattr(torch, dtype)
    for k, v in raw.items():
        matmul = k.rsplit(".", 1)[-1] in MATMUL_LEAVES
        assert cast[k].dtype == (cdt if matmul else torch.bfloat16), k
        assert torch.equal(cast[k].float(), v.float()), k
        assert got[k].dtype == cast[k].dtype and torch.equal(got[k], cast[k]), k
    for leaf in ("moe.router", "mamba.A_log", "mamba.D", "mamba.dt_bias",
                 "mamba.norm", "ffn_norm.scale"):
        assert cast[f"blocks.L1.{leaf}"].dtype == torch.bfloat16, leaf
    assert cast["blocks.L2.attn_norm.scale"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# forward, three modes; decode against teacher forcing
# ---------------------------------------------------------------------------

_JIT = {}


def _jit(what, jc, fn):
    """One jitted JAX function per (what, config), shared by the tests."""
    if (what, jc) not in _JIT:
        _JIT[what, jc] = fn()
    return _JIT[what, jc]


def _jfwd(jc):
    return _jit("forward", jc, lambda: jax.jit(
        partial(jax_forward, cfg=jc, rt=JAX_RT), static_argnames=("mode",)))


def _nodrop(cfg):
    """Capacity factor 16: no MoE assignment is dropped, so a prefill of
    many tokens and a decode step of one compute the same function (the
    JAX package's decode tests raise it likewise)."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            capacity_factor=16.0))


def test_forward_three_modes_match_jax():
    """fp32 compute on the bf16-stored tree: train mode (hidden states,
    aux), prefill (last-position logits; the attention layer's
    k/v/slot_pos and the Mamba layers' conv and SSM state; S 20 on chunk
    16, so the padded tail runs), and three decode steps on the padded
    prefill cache (logits and every cache leaf, written in place)."""
    jc, tc = _cfgs()
    npp = _params()
    jp, tp = jax.tree.map(jnp.asarray, npp), from_numpy_tree(npp)
    B, S, n = 2, 20, 3
    toks = _tokens(tc.vocab_size, B, S + n, 5)
    rel = REL["float32"]
    jfwd = _jfwd(jc)
    jh, _, jaux = jfwd(jp, tokens=jnp.asarray(toks[:, :S]), mode="train")
    th, taux = forward(tp, tc, CPU_RUNTIME, torch.from_numpy(toks[:, :S]), mode="train")
    assert _rel(jh, th) <= rel
    assert abs(float(taux) - float(jaux)) <= AUX_REL["float32"] * abs(float(jaux))
    jl, jcache, _ = jfwd(jp, tokens=jnp.asarray(toks[:, :S]), mode="prefill")
    tl, tcache = forward(tp, tc, CPU_RUNTIME, torch.from_numpy(toks[:, :S]),
                         mode="prefill")
    assert _rel(jl, tl) <= rel
    jflat = _flat(jcache)
    assert sorted(jflat) == sorted(tcache)
    assert {k.split(".")[1] + "." + k.split(".")[2] for k in tcache} == {
        "L0.mamba", "L1.mamba", "L2.attn", "L3.mamba"}
    for name, ref in jflat.items():
        assert tuple(tcache[name].shape) == ref.shape, name
        assert _rel(ref, tcache[name]) <= rel, name
    jcache, tcache = jeng.pad_cache(jcache, n), teng.pad_cache(tcache, n)
    for t in range(S, S + n):
        pos = np.full((B,), t, np.int32)
        jl, jcache, _ = jfwd(jp, tokens=jnp.asarray(toks[:, t:t + 1]), mode="decode",
                             cache=jcache, pos=jnp.asarray(pos))
        tl, out = forward(tp, tc, CPU_RUNTIME, torch.from_numpy(toks[:, t:t + 1]),
                          mode="decode", cache=tcache, pos=torch.from_numpy(pos))
        assert out is tcache and _rel(jl, tl) <= rel, t
        for name, ref in _flat(jcache).items():
            if name.endswith("slot_pos"):
                assert np.array_equal(np.asarray(ref), tcache[name].numpy()), (t, name)
            else:
                assert _rel(ref, tcache[name]) <= rel, (t, name)


def test_forward_block_by_block_matches_jax_in_bf16():
    """bf16 compute, each block of both periods fed the JAX package's
    hidden state (and, in decode, its cache): train mode (output, aux),
    prefill (output, cache) and one decode step on the padded prefill
    cache (output, every written cache leaf), each within 5e-2 of the
    max; the final norm likewise.  Whole, the bf16 stack cannot be held
    so: XLA keeps fused elementwise chains in fp32 where the port rounds
    each op to bf16 (about one bf16 step a block), and the 8 layers grow
    that, with a near tie routed otherwise, to 0.15-0.27 of the max on
    these inputs, as far as scaling one weight leaf by one bf16 step
    moves the port's own hidden states (0.27)."""
    from repro.models import layers as jlayers
    from repro.models import transformer as jtr
    from repro_torch.models import layers as tlayers
    from repro_torch.models import transformer as ttr
    jc, tc = _cfgs("bfloat16")
    npp = _params()
    jp, tp = jax.tree.map(jnp.asarray, npp), from_numpy_tree(npp)
    B, S = 2, 20
    toks = _tokens(tc.vocab_size, B, S + 1, 5)
    _, period, n_p = layer_pattern(tc)
    rel = REL["bfloat16"]

    def jblock(spec, mode):
        def run(p, h, pos, cache):
            return jtr.block_apply(p, spec, h, jc, JAX_RT, pos=pos, cache=cache,
                                   build_cache=mode != "train")
        return _jit(("block", spec, mode), jc, lambda: jax.jit(run))

    pos = {"train": np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy(),
           "decode": np.full((B,), S, np.int32)}
    pos["prefill"] = pos["train"]
    caches = {}
    for mode in ("train", "prefill", "decode"):
        cols = slice(S, S + 1) if mode == "decode" else slice(0, S)
        h = jnp.asarray(npp["embed"])[toks[:, cols]].astype(jnp.bfloat16)
        assert np.array_equal(_np32(h), _np32(
            tp["embed"][torch.from_numpy(toks[:, cols]).long()].bfloat16()))
        for i in range(n_p):
            for j, spec in enumerate(period):
                mix = "attn" if spec.mixer != "mamba" else "mamba"
                pj = jax.tree.map(lambda a: a[i], jp["blocks"][f"L{j}"])
                pre = f"blocks.L{j}."
                pt = {k[len(pre):]: v[i] for k, v in tp.items() if k.startswith(pre)}
                jcin = tcin = None
                if mode == "decode":
                    jcin = {mix: jax.tree.map(jnp.asarray, caches[i, j])}
                    tcin = {f"{mix}.{n}": torch.from_numpy(_np32(v)).to(
                        torch.int32 if n == "slot_pos" else
                        torch.float32 if n == "ssm" else torch.bfloat16)
                        for n, v in caches[i, j].items()}
                jh, jcout, jaux = jblock(spec, mode)(pj, h, jnp.asarray(pos[mode]), jcin)
                th, tcout, taux = ttr.block_apply(
                    pt, spec, torch.from_numpy(_np32(h)).bfloat16(), tc, CPU_RUNTIME,
                    pos=torch.from_numpy(pos[mode]), cache=tcin,
                    build_cache=mode != "train")
                what = (mode, i, j)
                assert _rel(jh, th) <= rel, what
                assert abs(float(taux) - float(jaux)) <= AUX_REL["bfloat16"] * max(
                    abs(float(jaux)), 1e-30), what
                if mode != "train":
                    for n, ref in jcout[mix].items():
                        got = tcout[f"{mix}.{n}"]
                        if n == "slot_pos":
                            assert np.array_equal(np.asarray(ref), got.numpy()), what
                        else:
                            assert _rel(ref, got) <= rel, (what, n)
                if mode == "prefill":
                    caches[i, j] = {n: np.asarray(v) for n, v in
                                    (jeng.pad_cache(jcout, 1)[mix]).items()}
                h = jh
        jn = jlayers.rmsnorm(jp["final_norm"], h, jc.norm_eps)
        tn = tlayers.rmsnorm(tp["final_norm.scale"], torch.from_numpy(_np32(h)).bfloat16(),
                             tc.norm_eps)
        assert _rel(jn, tn) <= rel, mode


def test_decode_continues_a_teacher_forced_prefill():
    """``tests/test_decode.py``'s consistency check on the port (fp32, at
    capacity factor 16): prefill 24 tokens, then each of 4 decode steps
    against the last-position logits of a prefill of the prefix it
    completes."""
    _, tc = _cfgs()
    tc = _nodrop(tc)
    tp = from_numpy_tree(_params())
    B, S, n = 2, 24, 4
    toks = torch.from_numpy(_tokens(tc.vocab_size, B, S + n, 3))
    _, cache = forward(tp, tc, CPU_RUNTIME, toks[:, :S], mode="prefill")
    cache = teng.pad_cache(cache, n)
    for i in range(n):
        pos = torch.full((B,), S + i, dtype=torch.int32)
        got, cache = forward(tp, tc, CPU_RUNTIME, toks[:, S + i:S + i + 1],
                             mode="decode", cache=cache, pos=pos)
        want, _ = forward(tp, tc, CPU_RUNTIME, toks[:, :S + i + 1], mode="prefill")
        np.testing.assert_allclose(got[:, -1].numpy(), want[:, -1].numpy(),
                                   atol=3e-3, rtol=1e-2, err_msg=f"step {i}")


def test_long_context_variant_keeps_the_attention_layer_global():
    """``for_long_context()`` sets the window (64 in the smoke variant),
    but the reference's ``layer_pattern`` gives a hybrid's attention
    layer the mixer "attn" whatever the window, so it stays global and
    its cache never rotates: the port's pattern and cache shapes are the
    JAX package's.  A prompt of 80 (past the window): 4 decode steps on
    the padded cache within 5e-5 of a teacher-forced prefill of each
    prefix (fp32, capacity factor 16), and bitwise the same decode on
    the variant without the window."""
    from repro.configs.base import layer_pattern as jax_layer_pattern
    jc, tc = _cfgs(long_context=True)
    _, base = _cfgs()
    assert tc.window == 64 and [s.mixer for s in layer_pattern(tc)[1]] == [
        s.mixer for s in jax_layer_pattern(jc)[1]] == ["mamba", "mamba", "attn", "mamba"]
    B, S, n = 1, 80, 4
    want = _flat(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                              jeng.cache_abstract(jc, B, S)))
    got = teng.cache_abstract(tc, B, S)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    assert got["blocks.L2.attn.slot_pos"].shape == (2, B, S)
    tp = from_numpy_tree(_params())
    toks = torch.from_numpy(_tokens(tc.vocab_size, B, S + n, 11))
    outs = {}
    for name, c in (("long", _nodrop(tc)), ("base", _nodrop(base))):
        _, cache = forward(tp, c, CPU_RUNTIME, toks[:, :S], mode="prefill")
        assert int(cache["blocks.L2.attn.slot_pos"][..., 0].max()) == 0
        cache = teng.pad_cache(cache, n)
        outs[name] = []
        for i in range(n):
            pos = torch.full((B,), S + i, dtype=torch.int32)
            got, cache = forward(tp, c, CPU_RUNTIME, toks[:, S + i:S + i + 1],
                                 mode="decode", cache=cache, pos=pos)
            outs[name].append(got)
            if name == "long":
                ref, _ = forward(tp, c, CPU_RUNTIME, toks[:, :S + i + 1],
                                 mode="prefill")
                assert _rel(ref[:, -1], got[:, -1]) <= REL["float32"], i
    assert all(torch.equal(a, b) for a, b in zip(outs["long"], outs["base"]))


# ---------------------------------------------------------------------------
# the loss, every gradient, SNGM on the engine
# ---------------------------------------------------------------------------

# the gradients of the first layers, at the far end of the backward pass
# through 8 layers, sit up to 1.5e-4 of their max from the JAX package's
# (L0's Mamba leaves; the same on an fp32-stored copy of the weights),
# where one fp32 ulp on one weight leaf moves them 1.5e-5 in the port
GRAD_REL = 5e-4
# a token that occurs more than once: the port rounds each occurrence's
# gradient row to bf16 before the scatter-add sums them, as the JAX
# source is written (a cast, then a gather's transpose), where XLA sums
# them in fp32 and rounds once; two rows that cancel leave 0 there and
# one bf16 step of a row here, so the embedding's gradient is held to one
# bf16 step of its largest magnitude
EMBED_GRAD_REL = BF16_STEP
STEP_REL = 2e-2


def _within(ref, got, rel):
    """max over the leaf of |got - ref| less one bf16 step of the value,
    against ``rel`` of the leaf's largest magnitude."""
    ref, got = _np32(ref), _np32(got)
    excess = np.abs(got - ref) - BF16_STEP * np.maximum(np.abs(ref), np.abs(got))
    return float(excess.max()) <= rel * max(float(np.abs(ref).max()), 1e-30)


def _jvg(jc):
    return _jit("value_and_grad", jc, lambda: jax.jit(jax.value_and_grad(
        partial(jstep.loss_fn, cfg=jc, rt=JAX_RT), has_aux=True)))


def _batches(vocab, n=3):
    r = np.random.RandomState(1)
    return [{"tokens": r.randint(0, vocab, (2, 24)).astype(np.int32),
             "loss_mask": (r.rand(2, 24) > 0.2).astype(np.float32)}
            for _ in range(n)]


def test_loss_aux_and_every_gradient_match_jax():
    """fp32 compute on the bf16-stored tree: the loss, the MoE aux loss
    and every (bf16) gradient; with remat the gradients are bitwise
    those without."""
    jc, tc = _cfgs()
    npp = _params()
    batch = _batches(tc.vocab_size, 1)[0]
    (jl, jm), jg = _jvg(jc)(jax.tree.map(jnp.asarray, npp),
                            jax.tree.map(jnp.asarray, batch))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = {}
    for remat in (False, True):
        tp = {k: v.requires_grad_() for k, v in from_numpy_tree(npp).items()}
        tl, tm = tstep.loss_fn(tp, tb, tc, Runtime(CPU, remat=remat))
        tl.backward()
        grads[remat] = {k: v.grad for k, v in tp.items()}
    assert abs(float(tl.detach()) - float(jl)) <= 2e-5 * abs(float(jl))
    jaux = float(jm["aux_loss"])
    assert jaux > 0 and abs(float(tm["aux_loss"].detach()) - jaux) <= 1e-6 * jaux
    want = from_numpy_tree(jax.tree.map(np.asarray, jg))
    assert set(want) == set(grads[True])
    for k, g in want.items():
        assert g.dtype == grads[False][k].dtype == torch.bfloat16, k
        if k == "embed":        # see EMBED_GRAD_REL
            assert _rel(g, grads[False][k]) <= EMBED_GRAD_REL, k
        else:
            assert _within(g, grads[False][k], GRAD_REL), k
        assert torch.equal(grads[True][k], grads[False][k]), k
    for leaf in ("L1.moe.router", "L1.moe.wg", "L2.attn.wq", "L0.mamba.A_log",
                 "L0.mamba.dt_bias", "L0.mamba.D", "L0.mamba.conv_b"):
        assert float(grads[False]["blocks." + leaf].abs().max()) > 0, leaf


def _sngm(mod, fused=None):
    sched = (jsched if mod is jopt else tsched).poly_power(0.5, 3)
    kw = {} if mod is jopt else {"fused": fused}
    return mod.sngm(sched, beta=0.9, weight_decay=1e-4, **kw)


def test_sngm_engine_bitwise_fused_none_with_two_launches_a_step():
    """3 SNGM steps (n_micro 2, bf16 compute, remat) on the engine and on
    ``fused=None``: params (bf16), momentum (fp32) and stats bitwise; one
    bf16 bucket; 1 chunk_sumsq + 1 fused_update a step."""
    _, tc = _cfgs("bfloat16")
    npp = _params()
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in _batches(tc.vocab_size)]
    runs = {}
    for fused in (None, "multi_tensor"):
        opt = _sngm(topt, fused)
        state = opt.init_state(from_numpy_tree(npp))
        fn = tstep.make_train_step(tc, Runtime(CPU, remat=True), opt, n_micro=2)
        stats, launches = [], []
        for b in batches:
            with kernels.count_kernel_calls() as c:
                state, st = fn(state, b)
            launches.append(c["calls"])
            stats.append({k: float(v) for k, v in st.items()})
        runs[fused] = (state, stats, launches)
    (sa, sta, _), (sb, stb, lb) = runs[None], runs["multi_tensor"]
    assert sta == stb and all(np.isfinite(s["loss"]) for s in stb)
    assert all(l["chunk_sumsq"] == 1 and l["fused_update"] == 1
               and sum(l.values()) == 2 for l in lb)
    o = sb.opt_state
    assert [b.dtype for b in o.p_flats] == [torch.bfloat16]
    assert [b.dtype for b in o.u_flats] == [torch.float32]
    pa, pb = sa.params_view, sb.params_view
    assert sorted(pa) == sorted(pb)
    for k in pa:
        assert pa[k].dtype == pb[k].dtype == torch.bfloat16, k
        assert torch.equal(pa[k].view(torch.int16), pb[k].view(torch.int16)), k
    ma, mb = topt.to_pytree(sa.opt_state), topt.to_pytree(sb.opt_state)
    for k, v in ma.momentum.items():
        assert v.dtype == mb.momentum[k].dtype == torch.float32, k
        assert torch.equal(v.view(torch.int32), mb.momentum[k].view(torch.int32)), k


def test_sngm_engine_matches_the_jax_plain_step_on_the_same_gradients():
    """3 SNGM steps on the port's engine against the JAX package's
    ``fused=None`` optimizer, both fed the JAX package's gradients of the
    loss at its own current weights (fp32 compute, bf16 storage): params
    and momentum within 2e-2 of each leaf's max, the bound of
    ``tests/test_torch_multi_tensor.py`` for bf16 params (XLA keeps
    ``g + wd*p`` in fp32 where the plain path rounds it to bf16), the
    stats 1e-6 relative."""
    jc, _ = _cfgs()
    jo = _sngm(jopt)
    jstep_opt = jax.jit(jo.step)
    jp = jax.tree.map(jnp.asarray, _params())
    js = jo.init(jp)
    opt = _sngm(topt, "multi_tensor")
    ts = opt.init_state(from_numpy_tree(_params()))
    for b in _batches(jc.vocab_size):
        g = _jvg(jc)(jp, jax.tree.map(jnp.asarray, b))[1]
        jp, js, jst = jstep_opt(g, js, jp)
        with kernels.count_kernel_calls() as c:
            ts, tst = opt.step_state(from_numpy_tree(jax.tree.map(np.asarray, g)), ts)
        assert c["calls"]["chunk_sumsq"] == c["calls"]["fused_update"] == 1
        for k in ("grad_norm", "lr", "update_norm"):
            assert abs(float(jst[k]) - float(tst[k])) <= 1e-6 * abs(float(jst[k])), k
    want_p = from_numpy_tree(jax.tree.map(np.asarray, jp))
    want_u = from_numpy_tree(jax.tree.map(np.asarray, js.momentum))
    got_p, got_u = ts.params_view, ts.opt_state.momentum
    assert sorted(want_p) == sorted(got_p)
    for k in want_p:
        assert want_p[k].dtype == got_p[k].dtype == torch.bfloat16, k
        assert want_u[k].dtype == got_u[k].dtype == torch.float32, k
        assert _rel(want_p[k], got_p[k]) <= STEP_REL, k
        assert _rel(want_u[k], got_u[k]) <= STEP_REL, k


# ---------------------------------------------------------------------------
# serving: the caches, the engines, the scheduler, the batcher
# ---------------------------------------------------------------------------

def test_cache_abstract_batch_axes_and_pad_cache_match_jax():
    """The mixed cache tree: the attention layer's k/v/slot_pos and the
    Mamba layers' conv/ssm; ``pad_cache`` grows the attention leaves and
    hands the state leaves back as they are, as the JAX package's."""
    jc, tc = _cfgs("bfloat16")
    want = _flat(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                              jeng.cache_abstract(jc, 2, 5)))
    got = teng.cache_abstract(tc, 2, 5)
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        assert tuple(got[k].shape) == a.shape and got[k].device.type == "meta", k
        assert str(got[k].dtype).removeprefix("torch.") == a.dtype.name, k
    axes = teng.cache_batch_axes(tc)
    assert axes == {k: int(v) for k, v in _flat(jeng.cache_batch_axes(jc)).items()}
    assert set(axes.values()) == {1}
    tp = from_numpy_tree(_params())
    _, cache = forward(tp, tc, CPU_RUNTIME,
                       torch.from_numpy(_tokens(tc.vocab_size, 2, 7, 0)), mode="prefill")
    padded = teng.pad_cache(cache, 5)
    jpadded = _flat(jeng.pad_cache(
        {"blocks": {f"L{j}": {m: {n: jnp.asarray(cache[f"blocks.L{j}.{m}.{n}"]
                                                 .float().numpy())
                                  for n in ("k", "v", "slot_pos", "conv", "ssm")
                                  if f"blocks.L{j}.{m}.{n}" in cache}}
                    for j, m in ((0, "mamba"), (1, "mamba"), (2, "attn"),
                                 (3, "mamba"))}}, 5))
    assert sorted(jpadded) == sorted(padded)
    for k, v in cache.items():
        assert tuple(padded[k].shape) == jpadded[k].shape, k
        if k.rsplit(".", 1)[-1] in ("conv", "ssm"):
            assert padded[k] is v, k
        else:
            assert np.array_equal(_np32(padded[k]), _np32(jpadded[k])), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_bitwise_matches_dense(dtype):
    """``tests/test_serving.py``'s geometry (2 prompts of 9, 7 new tokens,
    block size 4): step-by-step decode logits through the paged cache
    (the attention layer's pools read by the plain gather, the Mamba
    layers' per-slot state) bitwise the dense engine's.  (The paged
    kernel's plain version keeps the probabilities in fp32 where the
    gather path rounds them to bf16, as the kernel does on the card.)"""
    _, tc = _cfgs(dtype)
    tp = from_numpy_tree(_params())
    prefill = teng.make_prefill_step(tc, CPU_RUNTIME)
    step = teng.make_serve_step(tc, CPU_RUNTIME)
    gather = teng.make_serve_step(tc, Runtime(CPU, paged_kernel=False))
    B, S0, max_new, bs = 2, 9, 7, 4
    prompt = torch.from_numpy(_tokens(tc.vocab_size, B, S0, 0))
    nbmax = tpc.n_blocks_for(S0 + max_new, bs)
    logits, dense = prefill(tp, prompt)
    dense = teng.pad_cache(dense, nbmax * bs - S0)
    paged = tpc.paged_cache_init(tc, B, bs, 32, nbmax, CPU)
    assert {k.rsplit(".", 1)[-1] for k in paged} == {"kp", "vp", "bt", "conv", "ssm"}
    alloc = tpc.BlockAllocator(32, bs)
    _, dense2 = prefill(tp, prompt)
    for row in range(B):
        ids = [alloc.alloc() for _ in range(nbmax)]
        tpc.set_block_table(paged, row, ids)
        tpc.splice_prefill(paged, dense2, row, row, ids)
    tok_d = tok_p = torch.argmax(logits[:, -1], -1).to(torch.int32)
    pos = torch.full((B,), S0, dtype=torch.int32)
    before = {k: v.clone() for k, v in paged.items()}
    for i in range(max_new - 1):
        tok_d, ld, dense = step(tp, dense, tok_d[:, None], pos)
        tok_p, lp, paged = gather(tp, paged, tok_p[:, None], pos)
        assert torch.equal(ld, lp), i
        pos = pos + 1
    for k in ("blocks.L2.attn.kp", "blocks.L0.mamba.conv", "blocks.L3.mamba.ssm"):
        assert not torch.equal(paged[k], before[k]), k      # written in place
    for k in ("blocks.L0.mamba.conv", "blocks.L3.mamba.ssm"):
        assert torch.equal(paged[k], dense[k]), k


def test_splice_of_a_shared_prefix_leaves_the_shared_blocks_and_writes_every_state():
    """A COW-shared prefix (``skip_blocks`` 2 of 3): the shared pool
    blocks keep their bits, the unshared block takes the prefill's
    entries, and every Mamba layer's per-slot state row is written
    whole; the other slot's rows are untouched."""
    _, tc = _cfgs()
    tp = from_numpy_tree(_params())
    _, dense = teng.make_prefill_step(tc, CPU_RUNTIME)(
        tp, torch.from_numpy(_tokens(tc.vocab_size, 3, 11, 1)))
    paged = tpc.paged_cache_init(tc, 2, 4, 8, 3, CPU)
    for v in paged.values():
        v.fill_(7)
    tpc.splice_prefill(paged, dense, 2, 1, [3, 4, 5], skip_blocks=2)
    for k, v in paged.items():
        leaf = k.rsplit(".", 1)[-1]
        if leaf in ("conv", "ssm"):
            assert torch.equal(v[:, 1], dense[k][:, 2]) and (v[:, 0] == 7).all(), k
        elif leaf in ("kp", "vp"):
            src = dense[k[:-2] + leaf[0]][:, 2]               # (n_p, S, K, hd)
            assert (v[:, [0, 1, 2, 3, 4, 6, 7]] == 7).all(), k
            assert torch.equal(v[:, 5, :3], src[:, 8:11]), k
            assert (v[:, 5, 3:] == 0).all(), k                 # block cover padding
        else:
            assert (v == 7).all(), k                           # tables untouched


LENGTHS = (8, 13, 8, 13, 5)


def _prompts(vocab):
    """Five prompts; the 2nd and 4th share their first 8 tokens (two full
    blocks of 4) with the 1st, so copy-on-write shares pool blocks."""
    rng = np.random.RandomState(0)
    ps = [rng.randint(0, vocab, (n,)).astype(np.int32) for n in LENGTHS]
    for i in (1, 3):
        ps[i][:8] = ps[0]
    return ps


_JAX_PREFILL = {}


def _shared_prefill(make):
    """The JAX scheduler's ``make_prefill_step``, one function per (cfg,
    rt): ``jax.jit`` then reuses its compilations across schedulers (the
    two temperatures prefill the same shapes)."""
    def cached(cfg, rt):
        if (cfg, id(rt)) not in _JAX_PREFILL:
            _JAX_PREFILL[cfg, id(rt)] = make(cfg, rt)
        return _JAX_PREFILL[cfg, id(rt)]
    return cached


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_paged_scheduler_tokens_equal_jax_scheduler(temperature, monkeypatch):
    """Five requests on 3 slots, block size 4, chunks of 3, a pool that
    preempts, two prompts that share a prefix with a third (arriving a
    round after it, so its blocks are registered): every prefill at a
    prompt's exact length; the same tokens, prefill shapes and counters
    as the JAX scheduler (capacity counts the n_slots padding rows of
    every prefill in both)."""
    import repro.serving.scheduler as jax_scheduler
    monkeypatch.setattr(jax_scheduler, "make_prefill_step",
                        _shared_prefill(jax_scheduler.make_prefill_step))
    jc, tc = _cfgs()
    npp = _params()
    kw = dict(n_slots=3, block_size=4, n_blocks=10, ctx_max=20, decode_chunk=3,
              buckets=[8, 16], temperature=temperature, seed=5)
    outs, stats = [], []
    for Sched, Req, cfg, params, rt in (
            (JaxScheduler, JaxServeRequest, jc, jax.tree.map(jnp.asarray, npp), JAX_RT),
            (PagedScheduler, ServeRequest, tc, from_numpy_tree(npp), CPU_RUNTIME)):
        s = Sched(cfg, params, rt, **kw)
        reqs = [Req(rid=i, prompt=p.copy(), max_new=7)
                for i, p in enumerate(_prompts(tc.vocab_size))]
        s.submit(reqs[0])
        s.step()
        for r in reqs[1:]:
            s.submit(r)
        outs.append({r.rid: list(r.out) for r in s.run()})
        s.alloc.check()
        assert s.alloc.used_blocks == 0
        stats.append(s.stats)
    assert sorted(outs[1]) == list(range(len(LENGTHS)))
    assert outs[1] == outs[0]
    for key in ("prefill_shapes", "peak_used_blocks", "preemptions",
                "decode_steps", "prefill_calls"):
        assert stats[1][key] == stats[0][key], key
    assert stats[1]["preemptions"] > 0 and stats[1]["cow_shared_blocks"] > 0
    assert {b for _, b in stats[1]["prefill_shapes"]} >= set(LENGTHS)


def test_greedy_generate_matches_jax():
    jc, tc = _cfgs()
    npp = _params()
    prompt = _tokens(tc.vocab_size, 2, 9, 4)
    want = jeng.greedy_generate(jc, JAX_RT, jax.tree.map(jnp.asarray, npp),
                                jnp.asarray(prompt), 4)
    got = teng.greedy_generate(tc, CPU_RUNTIME, from_numpy_tree(npp),
                               torch.from_numpy(prompt), 4)
    assert got.dtype == torch.int32 and got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("temperature", [0.7])
def test_continuous_batcher_tokens_equal_jax_batcher(temperature):
    """Each prompt prefilled alone at its exact length and spliced into a
    slot another request may have left (the attention rows and the
    Mamba state rows alike)."""
    jc, tc = _cfgs()
    npp = _params()
    prompts, max_new = _prompts(tc.vocab_size), 4
    kw = dict(temperature=temperature, seed=5)
    jb = JaxBatcher(jc, jax.tree.map(jnp.asarray, npp), n_slots=2, ctx_len=20, **kw)
    tb = serve_launcher.ContinuousBatcher(tc, from_numpy_tree(npp), 2, 20,
                                          rt=CPU_RUNTIME, **kw)

    def drive(b, reqs):
        queue, done = list(reqs), {}
        while queue or any(s is not None for s in b.slots):
            for s in b.free_slots():
                if queue:
                    b._admit(queue.pop(0), s)
            if any(s is not None for s in b.slots):
                for r in b.decode_step():
                    done[r.rid] = list(r.out)
        return done
    ref = drive(jb, [JaxRequest(i, jnp.asarray(p)[None], max_new)
                     for i, p in enumerate(prompts)])
    got = drive(tb, [serve_launcher.Request(i, torch.from_numpy(p)[None], max_new)
                     for i, p in enumerate(prompts)])
    assert sorted(got) == list(range(len(prompts)))
    assert got == ref
    assert tb.prefill_shapes == {(1, n) for n in LENGTHS}


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

STEP = re.compile(r"^  step +(\d+) loss=(\S+) ")


@contextlib.contextmanager
def _fp32_smoke(*modules):
    """Each launcher module's ``smoke_variant`` at fp32 compute."""
    with pytest.MonkeyPatch.context() as m:
        for mod in modules:
            smoke = mod.smoke_variant
            m.setattr(mod, "smoke_variant", lambda c, smoke=smoke: dataclasses.replace(
                smoke(c), compute_dtype="float32"))
        yield m


def test_train_launchers_print_the_same_first_loss():
    argv = ["--arch", ARCH, "--reduced", "--steps", "1", "--batch", "4", "--seq",
            "16", "--n-micro", "2", "--optimizer", "sngm", "--fused",
            "multi_tensor", "--log-every", "1"]
    losses = {}
    with _fp32_smoke(jax_train_launcher, train_launcher):
        for name, main, extra in (("jax", jax_train_launcher.main, []),
                                  ("port", train_launcher.main, ["--device", "cpu"])):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                main(argv + extra)
            lines = out.getvalue().splitlines()
            assert lines[0].startswith(f"[train] {ARCH}-smoke: 6,655,456 params")
            losses[name] = [float(m.group(2)) for m in map(STEP.match, lines) if m]
    assert len(losses["jax"]) == len(losses["port"]) == 1
    assert all(np.isfinite(losses["port"]))
    assert abs(losses["port"][0] - losses["jax"][0]) <= 2e-5 * losses["jax"][0]


@pytest.mark.parametrize("engine", ["paged", "dense"])
def test_serve_launchers_give_the_same_tokens(engine):
    """``--arch jamba-1.5-large-398b --reduced`` on either engine (fp32
    compute): the port's launcher returns the JAX launcher's tokens
    (prompts from ``--seed``, weights from PRNGKey(0) in both)."""
    flags = ["--arch", ARCH, "--engine", engine, "--requests", "3", "--slots",
             "2", "--prompt-len", "6", "--max-new", "4"]
    seen = {}
    with _fp32_smoke(jax_serve_launcher, serve_launcher) as m:
        m.setattr(jax_serve_launcher, "_report",
                  lambda finished, *a: seen.update({r.rid: list(r.out) for r in finished}))
        m.setattr(sys, "argv", ["serve"] + flags)
        jax_serve_launcher.main()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            finished = serve_launcher.main(flags + ["--reduced", "--device", "cpu"])
    assert f"[serve:{engine}] 3 requests, 12 tokens" in out.getvalue()
    got = {r.rid: list(r.out) for r in finished}
    assert sorted(got) == [0, 1, 2] and got == seen
