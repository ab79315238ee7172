"""The Mamba2 (SSD) family in the port (mamba2-1.3b, a pure SSM stack)
against the JAX package: the parameter tree, ``forward`` in its three
modes, decode against a teacher-forced prefill, the loss and every
gradient, SNGM on the engine, the dense and paged engines, the
scheduler and the ``ContinuousBatcher``, and both launchers.

Model: the smoke variant of mamba2-1.3b (2 layers, d_model 256, chunk
16).  Weights are the JAX package's ``materialize(model_defs(cfg),
PRNGKey(0))`` carried across by ``repro_torch.convert``, except where
said; tokens come from numpy with a seed.  Bounds, and why:

  * forward logits, train-mode hidden states and the prefill and decode
    states (conv tail, SSM state): fp32 5e-5 and bf16 5e-2 of the
    largest magnitude, the model tests' bounds;
  * decode against a teacher-forced prefill of each prefix (the port
    alone): the reference's own ``atol`` 3e-3, ``rtol`` 1e-2
    (``tests/test_decode.py``; the chunked scan and the recurrence
    associate their sums otherwise);
  * ``loss_fn`` and every gradient: 2e-5 of each JAX gradient's largest
    magnitude, the loss 2e-5 relative, on weights redrawn at their true
    fan-in (the reference init reads a stacked leaf's fan-in from the
    layer axis); with remat the gradients are bitwise those without;
  * SNGM on the engine against ``fused=None``: bitwise, 3 steps, 2
    launches a step; the port's engine against the JAX package's
    ``fused=None`` optimizer on the same gradients: every parameter and
    momentum leaf within 2e-6 of its largest magnitude (fp32; the
    per-leaf norms are summed in other orders, a few ulp);
  * the paged scheduler, ``greedy_generate``, the ``ContinuousBatcher``
    and both launchers: the JAX package's tokens (fp32 compute);
  * the paged against the dense engine (the SSM state rides unpaged in
    both): bitwise.
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
from repro_torch.convert import from_numpy_tree
from repro_torch.core import optim as topt
from repro_torch.core import schedules as tsched
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import (CPU_RUNTIME, Runtime, cast_for_compute, count,
                                forward, materialize, model_defs)
from repro_torch.models.param import flatten_defs
from repro_torch.serving import engine as teng
from repro_torch.serving import paged_cache as tpc
from repro_torch.serving.scheduler import PagedScheduler, ServeRequest
from repro_torch.training import step as tstep

ARCH = "mamba2-1.3b"
CPU = torch.device("cpu")
REL = {"float32": 5e-5, "bfloat16": 5e-2}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(dtype="float32"):
    return [dataclasses.replace(mod.smoke_variant(mod.ARCHS[ARCH]),
                                compute_dtype=dtype) for mod in (jcfg, tcfg)]


# contracted dims of each stacked matmul leaf (layer axis first); the
# depthwise conv contracts its width
FAN_IN = ("wz", "wx", "wB", "wC", "wdt", "out_proj", "conv_w")
_PARAMS = {}


def _params(redraw=False):
    """The JAX package's smoke params as a numpy tree; with ``redraw``
    every matmul weight and the conv redrawn from numpy at 1/sqrt(its
    true fan-in, the leaf's second dim)."""
    if redraw not in _PARAMS:
        jc, _ = _cfgs()
        tree = jax.tree.map(np.asarray, jax_materialize(jax_model_defs(jc),
                                                        jax.random.PRNGKey(0)))
        if redraw:
            r = np.random.RandomState(0)
            m = tree["blocks"]["L0"]["mamba"]
            for k in FAN_IN:
                m[k] = np.asarray(r.randn(*m[k].shape) / np.sqrt(m[k].shape[1]),
                                  np.float32)
        _PARAMS[redraw] = tree
    return _PARAMS[redraw]


def _tokens(vocab, B, S, seed):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(np.int32)


def _rel(ref, got):
    ref = np.asarray(ref, np.float32)
    got = (got.detach().float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    return float(np.abs(ref - got).max()) / max(float(np.abs(ref).max()), 1e-30)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def test_full_width_defs_and_counts_match_jax():
    """15 leaves, 1,343,740,928 params; the analytic ``param_count`` reads
    1,343,532,032: the reference's ``_mamba_params`` leaves out ``conv_b``
    (48 x 4352)."""
    jd = jax_model_defs(jcfg.ARCHS[ARCH])
    td = model_defs(tcfg.ARCHS[ARCH])
    flat = jax.tree_util.tree_flatten_with_path(jd, is_leaf=is_def)[0]
    jflat = {".".join(str(k.key) for k in path): d for path, d in flat}
    tflat = flatten_defs(td)
    assert sorted(jflat) == sorted(tflat) and len(tflat) == 15
    for k, d in jflat.items():
        e = tflat[k]
        assert (d.shape, d.axes, d.init, d.scale) == (e.shape, e.axes, e.init, e.scale), k
    assert count(td) == jax_count(jd) == 1_343_740_928
    assert tcfg.ARCHS[ARCH].param_count() == 1_343_532_032 == count(td) - 48 * 4352
    assert tflat["blocks.L0.mamba.conv_w"].shape == (48, 4, 4352)
    assert tflat["blocks.L0.mamba.out_proj"].shape == (48, 4096, 2048)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "whisper-large-v3"])
def test_hybrid_and_encoder_decoder_still_raise(arch):
    """Both are ported since (``tests/test_torch_jamba.py``,
    ``tests/test_torch_whisper.py``): each tree is the JAX package's path
    for path.  The jamba hybrid's paged cache (pools and tables for the
    attention layer, per-slot conv and SSM state for the Mamba layers)
    has the JAX package's leaves, shapes and dtypes; the encoder-decoder's
    is refused, as the JAX package asserts "paged serving is
    decoder-only"."""
    cfg = tcfg.ARCHS[arch]
    jflat = {".".join(str(k.key) for k in path): d for path, d in
             jax.tree_util.tree_flatten_with_path(
                 jax_model_defs(jcfg.ARCHS[arch]), is_leaf=is_def)[0]}
    tflat = flatten_defs(model_defs(cfg))
    assert sorted(jflat) == sorted(tflat)
    for k, d in jflat.items():
        assert (d.shape, np.dtype(d.dtype).name) == (
            tflat[k].shape, str(tflat[k].dtype).removeprefix("torch.")), k
    if cfg.is_encoder_decoder:
        with pytest.raises(ValueError, match="decoder-only.*ROADMAP"):
            tpc.paged_cache_init(tcfg.smoke_variant(cfg), 2, 4, 4, 2, CPU)
        return
    from repro.serving import paged_cache as jpc
    want = _flat(jax.tree.map(np.asarray, jpc.paged_cache_init(
        jcfg.smoke_variant(jcfg.ARCHS[arch]), 2, 4, 4, 2)))
    got = tpc.paged_cache_init(tcfg.smoke_variant(cfg), 2, 4, 4, 2, CPU)
    assert sorted(got) == sorted(want)
    assert {k.rsplit(".", 1)[-1] for k in got} == {"kp", "vp", "bt", "conv", "ssm"}
    for k, a in want.items():
        assert tuple(got[k].shape) == a.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == a.dtype.name, k


def test_load_model_casts_each_leaf_as_cast_for_compute_does():
    """The serving launcher casts the projections, ``out_proj`` and the
    conv as each is drawn (the reference casts them at use); A_log, D,
    dt_bias and the norms stay fp32."""
    _, tc = _cfgs("bfloat16")
    got, n = serve_launcher.load_model(tc, CPU_RUNTIME, seed=0)
    want = cast_for_compute(materialize(model_defs(tc), prng.PRNGKey(0), CPU), tc)
    assert n == count(model_defs(tc)) and sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    pre = "blocks.L0.mamba."
    for leaf in ("wz", "wx", "wB", "wC", "wdt", "out_proj", "conv_w", "conv_b"):
        assert got[pre + leaf].dtype == torch.bfloat16, leaf
    for leaf in ("A_log", "D", "dt_bias", "norm"):
        assert got[pre + leaf].dtype == torch.float32, leaf
    assert got["blocks.L0.mixer_norm.scale"].dtype == torch.float32


# ---------------------------------------------------------------------------
# forward, three modes; decode against teacher forcing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_three_modes_match_jax(dtype):
    """Train mode (hidden states), prefill (last-position logits, the
    conv and SSM states; S 20 on chunk 16, so the padded tail runs), and
    three decode steps on the prefill's cache (logits and states)."""
    jc, tc = _cfgs(dtype)
    npp = _params()
    jp, tp = jax.tree.map(jnp.asarray, npp), from_numpy_tree(npp)
    B, S = 2, 20
    toks = _tokens(tc.vocab_size, B, S + 3, 5)
    rel = REL[dtype]
    jfwd = jax.jit(partial(jax_forward, cfg=jc, rt=JAX_RT),
                   static_argnames=("mode",))
    jh, _, _ = jfwd(jp, tokens=jnp.asarray(toks[:, :S]), mode="train")
    th, taux = forward(tp, tc, CPU_RUNTIME, torch.from_numpy(toks[:, :S]), mode="train")
    assert _rel(jh, th) <= rel and float(taux) == 0.0
    jl, jcache, _ = jfwd(jp, tokens=jnp.asarray(toks[:, :S]), mode="prefill")
    tl, tcache = forward(tp, tc, CPU_RUNTIME, torch.from_numpy(toks[:, :S]),
                         mode="prefill")
    assert _rel(jl, tl) <= rel
    jflat = _flat(jcache)
    assert sorted(jflat) == sorted(tcache) == ["blocks.L0.mamba.conv",
                                               "blocks.L0.mamba.ssm"]
    for name, ref in jflat.items():
        assert tuple(tcache[name].shape) == ref.shape, name
        assert _rel(ref, tcache[name]) <= rel, name
    for t in range(S, S + 3):
        pos = np.full((B,), t, np.int32)
        jl, jcache, _ = jfwd(jp, tokens=jnp.asarray(toks[:, t:t + 1]), mode="decode",
                             cache=jcache, pos=jnp.asarray(pos))
        tl, out = forward(tp, tc, CPU_RUNTIME, torch.from_numpy(toks[:, t:t + 1]),
                          mode="decode", cache=tcache, pos=torch.from_numpy(pos))
        assert out is tcache and _rel(jl, tl) <= rel, t
        for name, ref in _flat(jcache).items():
            assert _rel(ref, tcache[name]) <= rel, (t, name)


def test_decode_continues_a_teacher_forced_prefill():
    """``tests/test_decode.py``'s consistency check on the port: prefill
    24 tokens, then each of 4 decode steps against the last-position
    logits of a prefill of the prefix it completes (fp32)."""
    _, tc = _cfgs()
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


def test_short_prompt_refused_by_the_serving_paths():
    """The departure from the reference (ROADMAP Queue C): a prompt of
    fewer than conv_width - 1 = 3 tokens builds no decode state, so every
    path that prefills for decode refuses it."""
    _, tc = _cfgs()
    tp = from_numpy_tree(_params())
    short = torch.from_numpy(_tokens(tc.vocab_size, 1, 2, 0))
    with pytest.raises(ValueError, match="conv_width - 1 = 3"):
        teng.greedy_generate(tc, CPU_RUNTIME, tp, short, 4)
    s = PagedScheduler(tc, tp, CPU_RUNTIME, n_slots=2, block_size=4,
                       n_blocks=8, ctx_max=16)
    s.submit(ServeRequest(rid=0, prompt=short[0].numpy(), max_new=3))
    with pytest.raises(ValueError, match="2 tokens"):
        s.run()
    h, _ = forward(tp, tc, CPU_RUNTIME, short, mode="train")
    assert h.shape == (1, 2, tc.d_model)


# ---------------------------------------------------------------------------
# the loss, every gradient, SNGM on the engine
# ---------------------------------------------------------------------------

def test_loss_and_every_gradient_match_jax():
    jc, tc = _cfgs()
    npp = _params(redraw=True)
    r = np.random.RandomState(1)
    tokens = r.randint(0, tc.vocab_size, (2, 24)).astype(np.int32)
    mask = (r.rand(2, 24) > 0.2).astype(np.float32)
    batch = {"tokens": tokens, "loss_mask": mask}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        partial(jstep.loss_fn, cfg=jc, rt=JAX_RT), has_aux=True))(
        jax.tree.map(jnp.asarray, npp), jax.tree.map(jnp.asarray, batch))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = {}
    for remat in (False, True):
        tp = {k: v.requires_grad_() for k, v in from_numpy_tree(npp).items()}
        tl, tm = tstep.loss_fn(tp, tb, tc, Runtime(CPU, remat=remat))
        tl.backward()
        grads[remat] = {k: v.grad for k, v in tp.items()}
    assert abs(float(tl.detach()) - float(jl)) <= 2e-5 * abs(float(jl))
    assert float(tm["aux_loss"]) == 0.0
    want = from_numpy_tree(jax.tree.map(np.asarray, jg))
    assert set(want) == set(grads[True])
    for k, g in want.items():
        assert _rel(g, grads[False][k]) <= 2e-5, k
        assert torch.equal(grads[True][k], grads[False][k]), k
    for leaf in ("A_log", "D", "dt_bias", "conv_b", "norm"):
        assert float(grads[False]["blocks.L0.mamba." + leaf].abs().max()) > 0, leaf


def _sngm(mod, fused=None):
    sched = (jsched if mod is jopt else tsched).poly_power(0.5, 3)
    kw = {} if mod is jopt else {"fused": fused}
    return mod.sngm(sched, beta=0.9, weight_decay=1e-4, **kw)


def _batches(vocab, n=3):
    r = np.random.RandomState(2)
    return [{"tokens": r.randint(0, vocab, (4, 16)).astype(np.int32),
             "loss_mask": np.ones((4, 16), np.float32)} for _ in range(n)]


def test_sngm_engine_bitwise_fused_none_with_two_launches_a_step():
    """3 SNGM steps (n_micro 2, bf16 compute, remat) on the engine and on
    ``fused=None``: params, momentum and stats bitwise; 1 chunk_sumsq +
    1 fused_update a step."""
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
    pa, pb = sa.params_view, sb.params_view
    assert sorted(pa) == sorted(pb)
    for k in pa:
        assert torch.equal(pa[k].view(torch.int32), pb[k].view(torch.int32)), k
    ma, mb = topt.to_pytree(sa.opt_state), topt.to_pytree(sb.opt_state)
    for k, v in ma.momentum.items():
        assert torch.equal(v.view(torch.int32), mb.momentum[k].view(torch.int32)), k


def test_sngm_engine_matches_the_jax_plain_step_on_the_same_gradients():
    """3 SNGM steps on the port's engine against the JAX package's
    ``fused=None`` optimizer, both fed the JAX package's gradients of the
    loss at its own current weights (fp32): every parameter and momentum
    leaf within 2e-6 of its largest magnitude, the stats within 1e-6
    relative."""
    jc, _ = _cfgs()
    jgrad = jax.jit(jax.grad(lambda p, b: jstep.loss_fn(p, b, jc, JAX_RT)[0]))
    jo = _sngm(jopt)
    jstep_opt = jax.jit(jo.step)
    jp = jax.tree.map(jnp.asarray, _params(redraw=True))
    js = jo.init(jp)
    opt = _sngm(topt, "multi_tensor")
    ts = opt.init_state(from_numpy_tree(_params(redraw=True)))
    for b in _batches(jc.vocab_size):
        g = jgrad(jp, jax.tree.map(jnp.asarray, b))
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
        assert _rel(want_p[k], got_p[k]) <= 2e-6, k
        assert _rel(want_u[k], got_u[k]) <= 2e-6, k


# ---------------------------------------------------------------------------
# serving: the engines, the scheduler, the batcher
# ---------------------------------------------------------------------------

def test_cache_abstract_batch_axes_and_pad_cache_match_jax():
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
    assert axes == {"blocks.L0.mamba.conv": 1, "blocks.L0.mamba.ssm": 1}
    _, tp = _params(), from_numpy_tree(_params())
    _, cache = forward(tp, tc, CPU_RUNTIME,
                       torch.from_numpy(_tokens(tc.vocab_size, 2, 7, 0)), mode="prefill")
    padded = teng.pad_cache(cache, 5)
    jpadded = jeng.pad_cache({k: jnp.asarray(v.float().numpy()) for k, v in cache.items()}, 5)
    for k, v in cache.items():
        assert padded[k] is v and padded[k].shape == jpadded[k].shape, k


def test_paged_decode_bitwise_matches_dense():
    """``tests/test_serving.py``'s geometry (2 prompts of 9, 7 new tokens,
    block size 4): step-by-step decode logits through the paged cache,
    whose SSM state rides unpaged, bitwise the dense engine's."""
    _, tc = _cfgs()
    tp = from_numpy_tree(_params())
    prefill = teng.make_prefill_step(tc, CPU_RUNTIME)
    step = teng.make_serve_step(tc, CPU_RUNTIME)
    B, S0, max_new, bs = 2, 9, 7, 4
    prompt = torch.from_numpy(_tokens(tc.vocab_size, B, S0, 0))
    nbmax = tpc.n_blocks_for(S0 + max_new, bs)
    logits, dense = prefill(tp, prompt)
    dense = teng.pad_cache(dense, nbmax * bs - S0)
    paged = tpc.paged_cache_init(tc, B, bs, 32, nbmax, CPU)
    assert sorted(paged) == sorted(dense)
    alloc = tpc.BlockAllocator(32, bs)
    _, dense2 = prefill(tp, prompt)
    for row in range(B):
        ids = [alloc.alloc() for _ in range(nbmax)]
        tpc.set_block_table(paged, row, ids)
        tpc.splice_prefill(paged, dense2, row, row, ids)
    for k in dense:
        assert torch.equal(paged[k], dense[k]), k
    tok_d = tok_p = torch.argmax(logits[:, -1], -1).to(torch.int32)
    pos = torch.full((B,), S0, dtype=torch.int32)
    for i in range(max_new - 1):
        tok_d, ld, dense = step(tp, dense, tok_d[:, None], pos)
        tok_p, lp, paged = step(tp, paged, tok_p[:, None], pos)
        assert torch.equal(ld, lp), i
        pos = pos + 1


def test_splice_prefill_rewrites_a_dirty_slot_even_when_every_block_is_shared():
    """The per-slot state is copied whole into the slot (a preempted or
    finished request's state there is replaced), also when copy-on-write
    shares every block of the prompt and no pool block is written."""
    _, tc = _cfgs()
    tp = from_numpy_tree(_params())
    _, dense = teng.make_prefill_step(tc, CPU_RUNTIME)(
        tp, torch.from_numpy(_tokens(tc.vocab_size, 3, 8, 1)))
    paged = tpc.paged_cache_init(tc, 2, 4, 8, 4, CPU)
    for v in paged.values():
        v.fill_(7)
    tpc.splice_prefill(paged, dense, 2, 1, [3, 4], skip_blocks=2)
    for k, v in paged.items():
        assert torch.equal(v[:, 1], dense[k][:, 2]) and (v[:, 0] == 7).all(), k


LENGTHS = (8, 5, 11, 8, 5)


def _prompts(vocab):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in LENGTHS]


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_paged_scheduler_tokens_equal_jax_scheduler(temperature):
    """Five requests on 3 slots, block size 4, buckets 8 and 16 (which an
    SSM stack ignores: every prefill is at a prompt's exact length),
    chunks of 3, a pool that preempts (a preempted request is prefilled
    again into a slot another request left): the same tokens, prefill
    shapes and counters."""
    jc, tc = _cfgs()
    npp = _params()
    kw = dict(n_slots=3, block_size=4, n_blocks=10, ctx_max=20, decode_chunk=3,
              buckets=[8, 16], temperature=temperature, seed=5)
    outs, stats = [], []
    for Sched, Req, cfg, params, rt in (
            (JaxScheduler, JaxServeRequest, jc, jax.tree.map(jnp.asarray, npp), JAX_RT),
            (PagedScheduler, ServeRequest, tc, from_numpy_tree(npp), CPU_RUNTIME)):
        s = Sched(cfg, params, rt, **kw)
        for i, p in enumerate(_prompts(tc.vocab_size)):
            s.submit(Req(rid=i, prompt=p.copy(), max_new=7))
        outs.append({r.rid: list(r.out) for r in s.run()})
        s.alloc.check()
        assert s.alloc.used_blocks == 0
        stats.append(s.stats)
    assert sorted(outs[1]) == list(range(len(LENGTHS)))
    assert outs[1] == outs[0]
    for key in ("prefill_shapes", "peak_used_blocks", "preemptions",
                "decode_steps", "prefill_calls"):
        assert stats[1][key] == stats[0][key], key
    assert stats[1]["preemptions"] > 0
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


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_continuous_batcher_tokens_equal_jax_batcher(temperature):
    """Each prompt prefilled alone at its exact length and its state
    spliced into a slot another request may have left."""
    jc, tc = _cfgs()
    npp = _params()
    prompts, max_new = _prompts(tc.vocab_size), 4
    kw = dict(temperature=temperature, seed=5)
    jb = JaxBatcher(jc, jax.tree.map(jnp.asarray, npp), n_slots=2, ctx_len=16, **kw)
    tb = serve_launcher.ContinuousBatcher(tc, from_numpy_tree(npp), 2, 16,
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
            assert lines[0].startswith(f"[train] {ARCH}-smoke: 1,080,480 params")
            losses[name] = [float(m.group(2)) for m in map(STEP.match, lines) if m]
    assert len(losses["jax"]) == len(losses["port"]) == 1
    assert all(np.isfinite(losses["port"]))
    assert abs(losses["port"][0] - losses["jax"][0]) <= 2e-5 * losses["jax"][0]


@pytest.mark.parametrize("engine", ["paged", "dense"])
def test_serve_launchers_give_the_same_tokens(engine, monkeypatch):
    """``--arch mamba2-1.3b --reduced`` on either engine (fp32 compute):
    the port's launcher returns the JAX launcher's tokens (prompts from
    ``--seed``, weights from PRNGKey(0) in both)."""
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
