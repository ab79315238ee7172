"""The Whisper encoder-decoder in the port (whisper-large-v3) against the
JAX package: the parameter tree, LayerNorm, the ungated MLP, the
encoder, ``forward`` in its three modes with the cross cache, decode
against a teacher-forced prefill, the dense cache's shapes, axes and
padding, ``greedy_generate``, the loss and every gradient, SNGM on the
engine, the train launcher's frame embeddings, and the paths that
refuse an encoder-decoder (the paged engine, the dense batcher, the
serve launcher), as the JAX package's do.

Model: the smoke variant of whisper-large-v3 (2 encoder + 2 decoder
layers, d_model 256, 4 heads, encoder_len 16).  Weights are the JAX
package's ``materialize(model_defs(cfg), PRNGKey(0))`` carried across by
``repro_torch.convert``, with every matmul weight redrawn from numpy at
1/sqrt(its true fan-in) (the reference init reads a stacked leaf's
fan-in from the layer axis) and every norm scale and bias drawn at
random, so that a dropped bias or a swapped scale shows.  Tokens and
frame embeddings come from numpy with a seed.  Bounds, and why:

  * LayerNorm: fp32 1e-6 relative to the largest magnitude; bf16 one
    bf16 step of each value (both round the same fp32 formula);
  * the MLP, the encoder, forward's logits, hidden states and caches:
    fp32 5e-5 and bf16 5e-2 of the largest magnitude, the model tests'
    bounds;
  * decode against a teacher-forced prefill (the port alone): the
    reference's own ``atol`` 3e-3, ``rtol`` 1e-2 (``tests/test_decode.py``);
  * ``loss_fn`` and every gradient: 5e-5 of each JAX gradient's largest
    magnitude, the loss 5e-5 relative; with remat the gradients are
    bitwise those without;
  * SNGM on the engine against ``fused=None`` and ``pad_cache``'s cross
    leaves: bitwise;
  * the launcher's frame embeddings against ``jax.random.normal``:
    ``prng.NORMAL_ULP`` float32 ulps, the bound of the port's ``normal``
    (``tests/test_torch_prng.py``: its ``erf_inv`` is PyTorch's ``log1p``,
    not XLA's);
  * ``greedy_generate``: the JAX package's tokens (fp32 compute).
"""
import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfg
from repro.models import CPU_RUNTIME as JAX_RT
from repro.models import forward as jax_forward
from repro.models import layers as jl
from repro.models import model_defs as jax_model_defs
from repro.models import transformer as jt
from repro.models.param import count as jax_count
from repro.models.param import is_def, materialize as jax_materialize
from repro.serving import engine as jeng
from repro.training import step as jstep
from repro_torch import configs as tcfg
from repro_torch import kernels, prng
from repro_torch.convert import from_numpy_tree
from repro_torch.core import optim as topt
from repro_torch.core import schedules as tsched
from repro_torch.data.format import pack_dataset
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import (CPU_RUNTIME, Runtime, cast_for_compute, count,
                                forward, materialize, model_defs)
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.models.param import flatten_defs
from repro_torch.serving import engine as teng
from repro_torch.serving import paged_cache as tpc
from repro_torch.serving.scheduler import PagedScheduler
from repro_torch.training import step as tstep

ARCH = "whisper-large-v3"
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


# number of contracted dims after the layer axis of each stacked matmul leaf
FAN_IN = {"wq": 1, "wk": 1, "wv": 1, "wo": 2, "w1": 1, "w2": 1}
_PARAMS = {}


def _perturb(tree, r):
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb(v, r)
        elif k in FAN_IN:
            fan = int(np.prod(v.shape[1:1 + FAN_IN[k]]))
            tree[k] = np.asarray(r.randn(*v.shape) / np.sqrt(fan), np.float32)
        elif k == "scale":
            tree[k] = np.asarray(1 + 0.1 * r.randn(*v.shape), np.float32)
        elif k in ("bias", "b1", "b2"):
            tree[k] = np.asarray(0.1 * r.randn(*v.shape), np.float32)


def _params():
    """The JAX package's smoke params as a numpy tree, matmul weights
    redrawn at their true fan-in, norm scales and biases at random."""
    if not _PARAMS:
        jc, _ = _cfgs()
        tree = jax.tree.map(np.array, jax_materialize(jax_model_defs(jc),
                                                      jax.random.PRNGKey(0)))
        _perturb(tree, np.random.RandomState(0))
        _PARAMS["p"] = tree
    return _PARAMS["p"]


def _both():
    npp = _params()
    return jax.tree.map(jnp.asarray, npp), from_numpy_tree(npp)


def _tokens(vocab, B, S, seed):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(np.int32)


def _frames(cfg, B, seed):
    return np.random.RandomState(seed).randn(
        B, cfg.encoder_len, cfg.d_model).astype(np.float32)


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


def _sub(flat, name):
    pre = name + "."
    return {k[len(pre):]: v for k, v in flat.items() if k.startswith(pre)}


# ---------------------------------------------------------------------------
# parameter tree
# ---------------------------------------------------------------------------

def test_full_width_defs_and_counts_match_jax():
    """35 leaves, 1,535,219,200 params: the JAX package's tree path for
    path (shape, dtype, axes, init, scale), built without allocating.
    The analytic ``param_count`` reads 1,954,113,280, 418,894,080 more
    (the reference's own count; ROADMAP.md Queue C)."""
    jd = jax_model_defs(jcfg.ARCHS[ARCH])
    td = model_defs(tcfg.ARCHS[ARCH])
    flat = jax.tree_util.tree_flatten_with_path(jd, is_leaf=is_def)[0]
    jflat = {".".join(str(k.key) for k in path): d for path, d in flat}
    tflat = flatten_defs(td)
    assert sorted(jflat) == sorted(tflat) and len(tflat) == 35
    for k, d in jflat.items():
        e = tflat[k]
        assert (d.shape, d.axes, d.init, d.scale) == (e.shape, e.axes, e.init, e.scale), k
        assert np.dtype(d.dtype).name == str(e.dtype).removeprefix("torch."), k
    assert count(td) == jax_count(jd) == 1_535_219_200
    assert tcfg.ARCHS[ARCH].param_count() == 1_954_113_280 == count(td) + 418_894_080
    assert tflat["encoder.blocks.L0.ffn.w1"].shape == (32, 1280, 5120)
    assert tflat["blocks.L0.cross.wk"].shape == (32, 1280, 20, 64)
    assert "qn" not in _sub(tflat, "blocks.L0.cross")
    for norm in ("final_norm", "encoder.final_norm", "blocks.L0.cross_norm"):
        assert sorted(_sub(tflat, norm)) == ["bias", "scale"], norm


def test_load_model_casts_the_mlp_biases_with_the_matmul_weights():
    """The serving launcher casts every projection and the MLP's w1, b1,
    w2, b2 to the compute dtype as each is drawn (the reference casts
    them at use: the same bits); the LayerNorms and the embedding stay
    fp32."""
    _, tc = _cfgs("bfloat16")
    got, n = serve_launcher.load_model(tc, CPU_RUNTIME, seed=0)
    want = cast_for_compute(materialize(model_defs(tc), prng.PRNGKey(0), CPU), tc)
    assert n == count(model_defs(tc)) and sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    for pre in ("blocks.L0.ffn.", "encoder.blocks.L0.ffn."):
        for leaf in ("w1", "b1", "w2", "b2"):
            assert got[pre + leaf].dtype == torch.bfloat16, pre + leaf
    for leaf in ("blocks.L0.cross.wk", "encoder.blocks.L0.attn.wq"):
        assert got[leaf].dtype == torch.bfloat16, leaf
    for leaf in ("embed", "final_norm.bias", "blocks.L0.cross_norm.scale",
                 "encoder.final_norm.bias"):
        assert got[leaf].dtype == torch.float32, leaf


# ---------------------------------------------------------------------------
# LayerNorm, the ungated MLP, the encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    """eps 1e-5 whatever ``cfg.norm_eps`` says, population variance, and
    ``apply_norm`` picks it by the subtree's bias."""
    r = np.random.RandomState(3)
    x = (3 + 2 * r.randn(4, 7, 256)).astype(np.float32)
    p = {"scale": (1 + 0.1 * r.randn(256)).astype(np.float32),
         "bias": (0.1 * r.randn(256)).astype(np.float32)}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(jl.layernorm(jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _, tc = _cfgs()
    got = tl.apply_norm(tc, tp, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    assert torch.equal(got, tl.layernorm(tp["scale"], tp["bias"],
                                         torch.from_numpy(x).to(tdt)))
    got = got.float().numpy()
    if dtype == "float32":
        assert _rel(want, got) <= 1e-6
    else:
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= step).all()
    rms = tl.apply_norm(tc, {"scale": tp["scale"]}, torch.from_numpy(x))
    assert torch.equal(rms, tl.rmsnorm(tp["scale"], torch.from_numpy(x),
                                       tc.norm_eps))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ungated_mlp_and_encode_match_jax(dtype):
    jc, tc = _cfgs(dtype)
    jp, tp = _both()
    npp = _params()
    x = np.random.RandomState(4).randn(2, 9, tc.d_model).astype(np.float32)
    jffn = jax.tree.map(lambda a: jnp.asarray(a[0]),
                        npp["blocks"]["L0"]["ffn"])
    want = jl.mlp(jffn, jnp.asarray(x), jc)
    got = tl.mlp({k: v[0] for k, v in _sub(tp, "blocks.L0.ffn").items()},
                 torch.from_numpy(x), tc)
    assert got.dtype == getattr(torch, dtype)
    assert _rel(want, got) <= REL[dtype]
    enc = _frames(tc, 2, 5)
    want = jax.jit(partial(jt.encode, cfg=jc, rt=JAX_RT))(
        jp, encoder_embeds=jnp.asarray(enc))
    got = tt.encode(tp, tc, CPU_RUNTIME, torch.from_numpy(enc))
    assert got.shape == (2, tc.encoder_len, tc.d_model)
    assert _rel(want, got) <= REL[dtype]
    # remat changes nothing
    assert torch.equal(got, tt.encode(tp, tc, CPU_RUNTIME,
                                      torch.from_numpy(enc), remat=True))


# ---------------------------------------------------------------------------
# forward, three modes; decode against teacher forcing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_three_modes_match_jax(dtype):
    """Train mode (hidden states), prefill (last-position logits, the
    self-attention cache and the cross cache), then three decode steps
    on the padded caches (logits and every cache leaf); decode reads the
    cross cache, no frame embeddings."""
    jc, tc = _cfgs(dtype)
    jp, tp = _both()
    B, S = 2, 10
    toks = _tokens(tc.vocab_size, B, S + 3, 6)
    enc = _frames(tc, B, 7)
    rel = REL[dtype]
    jfwd = jax.jit(partial(jax_forward, cfg=jc, rt=JAX_RT),
                   static_argnames=("mode",))
    jh, _, _ = jfwd(jp, tokens=jnp.asarray(toks[:, :S]), mode="train",
                    encoder_embeds=jnp.asarray(enc))
    th, aux = forward(tp, tc, CPU_RUNTIME, torch.from_numpy(toks[:, :S]),
                      mode="train", encoder_embeds=torch.from_numpy(enc))
    assert _rel(jh, th) <= rel and float(aux) == 0.0
    jlog, jcache, _ = jfwd(jp, tokens=jnp.asarray(toks[:, :S]), mode="prefill",
                           encoder_embeds=jnp.asarray(enc))
    tlog, tcache = forward(tp, tc, CPU_RUNTIME, torch.from_numpy(toks[:, :S]),
                           mode="prefill", encoder_embeds=torch.from_numpy(enc))
    assert _rel(jlog, tlog) <= rel
    jflat = _flat(jcache)
    assert sorted(jflat) == sorted(tcache) == [
        "blocks.L0.attn.k", "blocks.L0.attn.slot_pos", "blocks.L0.attn.v",
        "blocks.L0.cross.ck", "blocks.L0.cross.cv"]
    for name, ref in jflat.items():
        assert tuple(tcache[name].shape) == ref.shape, name
        assert _rel(ref, tcache[name]) <= rel, name
    assert tcache["blocks.L0.cross.ck"].shape == (2, B, tc.encoder_len, 4, 64)
    jcache = jeng.pad_cache(jcache, 3)
    tcache = teng.pad_cache(tcache, 3)
    for t in range(S, S + 3):
        pos = np.full((B,), t, np.int32)
        jlog, jcache, _ = jfwd(jp, tokens=jnp.asarray(toks[:, t:t + 1]),
                               mode="decode", cache=jcache, pos=jnp.asarray(pos))
        tlog, out = forward(tp, tc, CPU_RUNTIME, torch.from_numpy(toks[:, t:t + 1]),
                            mode="decode", cache=tcache, pos=torch.from_numpy(pos))
        assert out is tcache and _rel(jlog, tlog) <= rel, t
        for name, ref in _flat(jcache).items():
            assert _rel(ref, tcache[name]) <= rel, (t, name)


def test_decode_continues_a_teacher_forced_prefill():
    """``tests/test_decode.py``'s consistency check on the port: prefill
    12 tokens with the frames, then each of 4 decode steps against the
    last-position logits of a prefill of the prefix it completes (fp32)."""
    _, tc = _cfgs()
    _, tp = _both()
    B, S, n = 2, 12, 4
    toks = torch.from_numpy(_tokens(tc.vocab_size, B, S + n, 3))
    enc = torch.from_numpy(_frames(tc, B, 8))
    _, cache = forward(tp, tc, CPU_RUNTIME, toks[:, :S], mode="prefill",
                       encoder_embeds=enc)
    cache = teng.pad_cache(cache, n)
    for i in range(n):
        pos = torch.full((B,), S + i, dtype=torch.int32)
        got, cache = forward(tp, tc, CPU_RUNTIME, toks[:, S + i:S + i + 1],
                             mode="decode", cache=cache, pos=pos)
        want, _ = forward(tp, tc, CPU_RUNTIME, toks[:, :S + i + 1],
                          mode="prefill", encoder_embeds=enc)
        np.testing.assert_allclose(got[:, -1].numpy(), want[:, -1].numpy(),
                                   atol=3e-3, rtol=1e-2, err_msg=f"step {i}")


# ---------------------------------------------------------------------------
# the dense cache: shapes, axes, padding; greedy generation
# ---------------------------------------------------------------------------

def test_cache_abstract_and_batch_axes_match_jax():
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
    assert set(axes.values()) == {1} and "blocks.L0.cross.ck" in axes


def test_pad_cache_grows_self_attention_and_leaves_the_cross_cache():
    """``ck``/``cv`` are the encoder's length, not the decode's: returned
    as they are (the same tensors), while k/v/slot_pos grow as the JAX
    package's do."""
    jc, tc = _cfgs()
    _, tp = _both()
    _, cache = forward(tp, tc, CPU_RUNTIME,
                       torch.from_numpy(_tokens(tc.vocab_size, 2, 7, 0)),
                       mode="prefill",
                       encoder_embeds=torch.from_numpy(_frames(tc, 2, 1)))
    padded = teng.pad_cache(cache, 5)
    jpadded = _flat(jeng.pad_cache(
        {"blocks": {"L0": {sub: {leaf: jnp.asarray(cache[f"blocks.L0.{sub}.{leaf}"].numpy())
                                 for leaf in leaves}
                           for sub, leaves in (("attn", ("k", "v", "slot_pos")),
                                               ("cross", ("ck", "cv")))}}}, 5))
    for k, v in cache.items():
        assert tuple(padded[k].shape) == jpadded[k].shape, k
        np.testing.assert_array_equal(padded[k].numpy(), jpadded[k], err_msg=k)
    for k in ("blocks.L0.cross.ck", "blocks.L0.cross.cv"):
        assert padded[k] is cache[k]
    assert padded["blocks.L0.attn.k"].shape[2] == 7 + 5


def test_greedy_generate_matches_jax():
    jc, tc = _cfgs()
    jp, tp = _both()
    prompt = _tokens(tc.vocab_size, 2, 9, 4)
    enc = _frames(tc, 2, 9)
    want = jeng.greedy_generate(jc, JAX_RT, jp, jnp.asarray(prompt), 5,
                                encoder_embeds=jnp.asarray(enc))
    got = teng.greedy_generate(tc, CPU_RUNTIME, tp, torch.from_numpy(prompt), 5,
                               encoder_embeds=torch.from_numpy(enc))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the loss, every gradient, SNGM on the engine
# ---------------------------------------------------------------------------

def _batch(cfg, B, S, seed):
    r = np.random.RandomState(seed)
    return {"tokens": r.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "loss_mask": (r.rand(B, S) > 0.2).astype(np.float32),
            "encoder_embeds": r.randn(B, cfg.encoder_len,
                                      cfg.d_model).astype(np.float32)}


def test_loss_and_every_gradient_match_jax():
    """fp32: the loss within 5e-5 relative, every gradient (the encoder's,
    the cross-attention's, the biases') within 5e-5 of its largest
    magnitude; with remat (the encoder's layers and the decoder's
    blocks) the gradients are bitwise those without."""
    jc, tc = _cfgs()
    npp = _params()
    batch = _batch(tc, 2, 12, 1)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        partial(jstep.loss_fn, cfg=jc, rt=JAX_RT), has_aux=True))(
        jax.tree.map(jnp.asarray, npp), jax.tree.map(jnp.asarray, batch))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = {}
    for remat in (False, True):
        tp = {k: v.requires_grad_() for k, v in from_numpy_tree(npp).items()}
        tloss, _ = tstep.loss_fn(tp, tb, tc, Runtime(CPU, remat=remat))
        tloss.backward()
        grads[remat] = {k: v.grad for k, v in tp.items()}
    assert abs(float(tloss.detach()) - float(jloss)) <= 5e-5 * abs(float(jloss))
    want = from_numpy_tree(jax.tree.map(np.asarray, jg))
    assert set(want) == set(grads[True]) and len(want) == 35
    for k, g in want.items():
        assert _rel(g, grads[False][k]) <= 5e-5, k
        assert torch.equal(grads[True][k], grads[False][k]), k
    for leaf in ("encoder.blocks.L0.ffn.b1", "blocks.L0.cross.wk",
                 "blocks.L0.cross_norm.bias", "encoder.final_norm.scale"):
        assert float(grads[False][leaf].abs().max()) > 0, leaf


def test_sngm_engine_bitwise_fused_none_with_n_micro_2():
    """3 SNGM steps (n_micro 2 splitting the frames with the tokens, bf16
    compute, remat) on the engine and on ``fused=None``: params,
    momentum and stats bitwise; 1 chunk_sumsq + 1 fused_update a step."""
    _, tc = _cfgs("bfloat16")
    npp = _params()
    batches = [{k: torch.from_numpy(v) for k, v in _batch(tc, 4, 8, 10 + i).items()}
               for i in range(3)]
    runs = {}
    for fused in (None, "multi_tensor"):
        opt = topt.sngm(tsched.poly_power(0.5, 3), beta=0.9, weight_decay=1e-4,
                        fused=fused)
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
    assert sorted(pa) == sorted(pb) and len(pa) == 35
    for k in pa:
        assert torch.equal(pa[k].view(torch.int32), pb[k].view(torch.int32)), k
    ma, mb = topt.to_pytree(sa.opt_state), topt.to_pytree(sb.opt_state)
    for k, v in ma.momentum.items():
        assert torch.equal(v.view(torch.int32), mb.momentum[k].view(torch.int32)), k


def test_micro_batches_split_the_frames_with_their_tokens():
    """The mean of the two half-batches' gradients is the whole batch's
    (fp32, within 1e-5 of the largest magnitude): each micro-batch reads
    its own rows of the frame embeddings."""
    _, tc = _cfgs()
    npp = _params()
    b = {k: torch.from_numpy(v) for k, v in _batch(tc, 4, 8, 20).items()}
    b["loss_mask"] = torch.ones_like(b["loss_mask"])
    grads = []
    for n_micro in (1, 2):
        opt = topt.sngm(tsched.poly_power(0.5, 3), fused=None)
        state = opt.init_state(from_numpy_tree(npp))
        params, flat = tstep._grad_leaves(state)
        mb = 4 // n_micro
        for i in range(n_micro):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in b.items()}
            tstep.loss_fn(params, micro, tc, CPU_RUNTIME)[0].backward()
        grads.append(tstep._mean_grads(params, flat, n_micro))
    for k, g in grads[0].items():
        assert _rel(g.numpy(), grads[1][k]) <= 1e-5, k


# ---------------------------------------------------------------------------
# the train launcher
# ---------------------------------------------------------------------------

def test_launcher_frames_are_the_jax_draw_and_a_reduced_run_trains():
    """Batch ``t``'s frame embeddings are ``jax.random.normal(PRNGKey(t),
    (B, encoder_len, d))`` within ``prng.NORMAL_ULP`` ulps, whatever
    ``--seed``, and bitwise ``prng.normal`` of that key; the reduced
    whisper trains 2 finite steps on the engine."""
    args = train_launcher.parse_args(
        ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "4",
         "--seq", "16", "--seed", "3", "--optimizer", "sngm", "--fused",
         "multi_tensor"])
    run = train_launcher.build(args)
    cfg = run.cfg
    for t in (0, 5):
        b = run.data.batch_at(t)
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(t),
                                            (4, cfg.encoder_len, cfg.d_model)))
        got = b["encoder_embeds"]
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert torch.equal(got, prng.normal(prng.PRNGKey(t), want.shape))
        ulps = np.abs(got.numpy().view(np.int32).astype(np.int64)
                      - want.view(np.int32))
        assert ulps.max() <= prng.NORMAL_ULP
        assert b["tokens"].shape == (4, 16)
    losses = train_launcher.main(
        ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "4",
         "--seq", "16", "--steps", "2", "--optimizer", "sngm", "--fused",
         "multi_tensor", "--log-every", "1"])
    assert len(losses) == 2 and all(math.isfinite(l) for l in losses)


def test_data_dir_needs_frames_and_passes_them_through(tmp_path):
    """A pack without an ``encoder_embeds`` field is refused, as by the
    JAX launcher; one with it trains, the loader carrying the field."""
    _, tc = _cfgs()
    r = np.random.RandomState(0)
    n, seq = 16, 8
    base = {"tokens": r.randint(0, tc.vocab_size, (n, seq)).astype(np.int32),
            "loss_mask": np.ones((n, seq), np.float32)}
    meta = {"vocab_size": tc.vocab_size, "seq_len": seq}
    pack_dataset(str(tmp_path / "lm"), base, shard_size=8, meta=meta)
    pack_dataset(str(tmp_path / "enc"), dict(base, encoder_embeds=r.randn(
        n, tc.encoder_len, tc.d_model).astype(np.float32)), shard_size=8,
        meta=meta)
    flags = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "4",
             "--steps", "2", "--fused", "multi_tensor", "--prefetch", "0",
             "--log-every", "1"]
    with pytest.raises(SystemExit, match="encoder_embeds"):
        train_launcher.main(flags + ["--data-dir", str(tmp_path / "lm")])
    losses = train_launcher.main(flags + ["--data-dir", str(tmp_path / "enc")])
    assert len(losses) == 2 and all(math.isfinite(l) for l in losses)


# ---------------------------------------------------------------------------
# the paths that refuse an encoder-decoder
# ---------------------------------------------------------------------------

def test_paged_engine_batcher_and_serve_launcher_refuse_whisper():
    """The JAX package's paged cache and scheduler assert "paged serving
    is decoder-only", and its serve launcher fails on whisper on both
    engines: the port refuses each with a message naming the way it
    serves (``greedy_generate``) and ROADMAP.md Queue C."""
    _, tc = _cfgs()
    with pytest.raises(ValueError, match="decoder-only.*Queue C"):
        tpc.paged_cache_init(tc, 2, 4, 4, 2, CPU)
    with pytest.raises(ValueError, match="decoder-only"):
        PagedScheduler(tc, {}, CPU_RUNTIME, n_slots=2, block_size=4,
                       n_blocks=8, ctx_max=16)
    with pytest.raises(ValueError, match="greedy_generate"):
        serve_launcher.ContinuousBatcher(tc, {}, 2, 16, rt=CPU_RUNTIME)
    for engine in ("paged", "dense"):
        with pytest.raises(SystemExit, match="greedy_generate.*Queue C"):
            serve_launcher.main(["--arch", ARCH, "--reduced", "--device",
                                 "cpu", "--engine", engine])
