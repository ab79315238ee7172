"""The reference's precision and remat switches in the port against the
JAX package: ``bf16_dot`` (bf16-in, f32-out products and their
backward), ``cfg.sdpa_bf16`` (the attention score products), the loss's
``cfg.logits_bf16``, ``Runtime.gather_dtype`` (the loss casts the stored
fp32 leaves of two or more dims) and sqrt-remat grouping of deep
stacks (``transformer._remat_group``).

Inputs come from numpy with a seed; the models are the smoke variants
of gemma-2b (G = 4 query heads a kv head), whisper-large-v3 (2 + 2
layers) and deepseek-v2-lite-16b, on the weights of the model tests
(``tests/test_torch_train.py``, ``test_torch_whisper.py``,
``test_torch_deepseek_v2.py``: matmul weights at their true fan-in).
Bounds, and why ("of max": of the largest magnitude of the JAX value;
"a step": one bf16 step of the value, 2^-7 max(|x|, |y|)):

  * ``bf16_dot``: forward 1e-5 of max (the products of bf16 values are
    exact in fp32; only the order of the sums differs); each cotangent
    a step plus 1e-5 of max (both round the same fp32 sum to bf16; a
    sum near a rounding edge can land on either side).  The cotangent
    is not rounded before the backward product, as XLA does it: a port
    that rounded it would miss that bound (held below);
  * ``_sdpa_seq(bf16_mm=True)``: the output 1e-5 of max; the q and v
    cotangents a step plus 1e-5 of max; k's a step plus 1e-5 of max for
    G = 1 and 1e-2 of max for G > 1: the reference repeats K to every
    query head, rounds each head's cotangent to bf16 and adds the G
    heads in bf16, where the port keeps the G heads of a kv head in one
    product and rounds their fp32 sum once (4.2e-3 of max measured);
  * the model's outputs with ``sdpa_bf16`` (logits, caches, whisper's
    encoder and cross attention): bf16 compute 5e-2 of max, the model
    tests' bound; fp32 compute ``SDPA_REL`` 5e-4 of max, ten times the
    model tests' 5e-5: with the score operands rounded to bf16, an fp32
    difference of an ulp between the packages turns into a bf16 step
    of a score now and then (whisper's encoder output 6.4e-5 and its
    logits 8.1e-5 against JAX; one ulp on the frames moves the port's
    own encoder output 2.9e-5);
  * ``loss_fn`` and every gradient with each switch (fp32 compute), a
    step of the value plus, of each leaf's max: ``logits_bf16`` 1e-4,
    ``gather_dtype`` 2e-3, ``sdpa_bf16`` and all three 1e-2 (measured
    2.1e-5, 4.9e-4, 2.8e-3).  An fp32 difference of 1e-7 between the
    two packages flips a bf16 rounding now and then, which moves every
    product of that element by one step of it; ``gather_dtype`` adds
    bf16 accumulations (the embedding's scatter-add, the tied
    unembedding added to it) that the two packages order differently;
    with bf16 compute 5e-2 of max, as the model tests (1.9e-2 measured);
  * sqrt-remat (gemma-2b at 12, 13 and 18 periods, whisper's decoder
    at 12, deepseek-v2-lite with a dense prefix and 12 MoE periods,
    mamba2 at 12; every stacked matrix at its true fan-in): grouped
    against per-block gradients, loss and aux loss bitwise (the same ops
    on the same inputs), against JAX's grouped ones 2e-5 of each leaf's
    max (the MoE and SSM stacks 1e-4: 3.0e-5 measured at 12 layers, with
    or without groups), the loss 2e-5 relative, the aux loss 1e-6.
"""
import dataclasses
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
from repro.models.param import is_def
from repro.models.param import materialize as jax_materialize
from repro.models.runtime import Runtime as JaxRuntime
from repro.serving import engine as jeng
from repro.training import step as jstep
from repro_torch import configs as tcfg
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.models import Runtime, forward, model_defs
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.models.param import flatten_defs
from repro_torch.serving import engine as teng
from repro_torch.serving import paged_cache as tpc
from repro_torch.training import step as tstep

import test_torch_deepseek_v2
import test_torch_train
import test_torch_whisper

CPU = torch.device("cpu")
REL = {"float32": 5e-5, "bfloat16": 5e-2}
SDPA_REL = {"float32": 5e-4, "bfloat16": 5e-2}     # outputs with sdpa_bf16
# loss_fn gradients at fp32 compute, beyond a step of the value, of each
# leaf's max (module docstring)
GRAD_EXCESS = {"logits_bf16": 1e-4, "gather_dtype": 2e-3, "sdpa_bf16": 1e-2,
               "all": 1e-2}
ARCH = {"gemma": "gemma-2b", "whisper": "whisper-large-v3",
        "dsv2": "deepseek-v2-lite-16b", "mamba2": "mamba2-1.3b"}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(ref, got):
    ref, got = _np(ref), _np(got)
    return float(np.abs(ref - got).max()) / max(float(np.abs(ref).max()), 1e-30)


def _excess(ref, got):
    """max(|ref - got| - one bf16 step of the value, 0) over max|ref|."""
    ref, got = _np(ref), _np(got)
    step = 2.0 ** -7 * np.maximum(np.abs(ref), np.abs(got))
    return float(np.maximum(np.abs(ref - got) - step, 0).max()) / max(
        float(np.abs(ref).max()), 1e-30)


def _cfgs(name, dtype="float32", **switches):
    return [dataclasses.replace(mod.smoke_variant(mod.ARCHS[ARCH[name]]),
                                compute_dtype=dtype, **switches)
            for mod in (jcfg, tcfg)]


def _params(name):
    """The model tests' smoke weights (true fan-in) as a numpy tree."""
    if name == "gemma":
        return test_torch_train._params("gemma-2b")
    if name == "whisper":
        return test_torch_whisper._params()
    return test_torch_deepseek_v2._params("lite", redraw=True)


def _batch(name, cfg, B=2, S=16, seed=1):
    r = np.random.RandomState(seed)
    batch = {"tokens": r.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "loss_mask": (r.rand(B, S) > 0.2).astype(np.float32)}
    if name == "whisper":
        batch["encoder_embeds"] = r.randn(B, cfg.encoder_len,
                                          cfg.d_model).astype(np.float32)
    return batch


# ---------------------------------------------------------------------------
# bf16_dot
# ---------------------------------------------------------------------------

# (batch, M, K, N): "long" contracts over more than K_CHUNK in the
# forward and in a's cotangent, so both sum chunk by chunk
DOT_SHAPES = {"mm": ((), 40, 96, 72), "bmm": ((3,), 40, 96, 72),
              "long": ((), 24, 2 * tl.K_CHUNK + 100, 2 * tl.K_CHUNK + 50)}


@pytest.mark.parametrize("operands", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", DOT_SHAPES)
def test_bf16_dot_and_its_cotangents_match_jax(shape, operands):
    r = np.random.RandomState(0)
    lead, M, K, N = DOT_SHAPES[shape]
    a = r.randn(*lead, M, K).astype(np.float32)
    b = r.randn(*lead, K, N).astype(np.float32)
    g = r.randn(*lead, M, N).astype(np.float32)
    eq = "nmk,nkj->nmj" if lead else "mk,kj->mj"
    jdt = jnp.dtype(operands)
    out, vjp = jax.vjp(lambda x, y: jnp.einsum(
        eq, x.astype(jnp.bfloat16), y.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32),
        jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt))
    want = (out,) + vjp(jnp.asarray(g))
    tdt = getattr(torch, operands)
    for fn in (tl.bf16_dot, tl.bf16_dot_ref):
        ta = torch.from_numpy(a).to(tdt).requires_grad_()
        tb = torch.from_numpy(b).to(tdt).requires_grad_()
        to = fn(ta, tb)
        to.backward(torch.from_numpy(g))
        assert to.dtype == torch.float32 and ta.grad.dtype == tb.grad.dtype == tdt
        assert _rel(want[0], to) <= 1e-5, fn.__name__
        for ref, got in zip(want[1:], (ta.grad, tb.grad)):
            assert _excess(ref, got) <= 1e-5, fn.__name__
    # the cotangent enters the backward product unrounded: rounding it
    # to bf16 first, as a bf16-only backward would, misses the bound
    gb = torch.from_numpy(g).bfloat16().float()
    bb = torch.from_numpy(b).bfloat16().float()
    rounded = (gb @ bb.mT).bfloat16()
    assert _excess(want[1], rounded) > 1e-5


def test_split3_terms_sum_to_the_value_exactly():
    x = torch.from_numpy((np.random.RandomState(3).randn(7, 5, 33)
                          * 10.0 ** np.arange(-3, 2)[:, None]).astype(np.float32))
    s = tl._split3(x)
    assert s.dtype == torch.bfloat16 and tuple(s.shape) == (7, 15, 33)
    hi, mid, lo = s.float().unflatten(-2, (3, 5)).unbind(-3)
    assert torch.equal(hi + mid + lo, x)


# ---------------------------------------------------------------------------
# _sdpa / _sdpa_seq with bf16_mm
# ---------------------------------------------------------------------------

SDPA = {  # S, T, H, K, causal, window, softcap
    "causal": (12, 12, 4, 2, True, 0, 0.0),
    "window": (12, 12, 4, 2, True, 4, 0.0),
    "softcap": (12, 12, 4, 2, True, 0, 5.0),
    "gqa4-cross": (10, 14, 8, 2, False, 0, 0.0),
    "mha": (12, 12, 4, 4, True, 0, 0.0),
    "two-chunks": (2 * tl.Q_CHUNK, 2 * tl.Q_CHUNK, 2, 1, True, 0, 0.0),
}


@pytest.mark.parametrize("case", SDPA)
def test_sdpa_seq_bf16_mm_and_its_gradients_match_jax(case):
    S, T, H, K, causal, window, cap = SDPA[case]
    hd, B = 16, 2
    r = np.random.RandomState(0)
    q, g = (r.randn(B, S, H, hd).astype(np.float32) for _ in range(2))
    k, v = (r.randn(B, T, K, hd).astype(np.float32) for _ in range(2))
    scale = hd ** -0.5
    jo, vjp = jax.vjp(lambda q, k, v: jl._sdpa_seq(
        q, k, v, causal, window, cap, scale, bf16_mm=True),
        *map(jnp.asarray, (q, k, v)))
    jdq, jdk, jdv = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    to = tl._sdpa_seq(tq, tk, tv, causal, window, cap, scale, bf16_mm=True)
    to.backward(torch.from_numpy(g))
    assert _rel(jo, to) <= 1e-5
    assert _excess(jdq, tq.grad) <= 1e-5 and _excess(jdv, tv.grad) <= 1e-5
    if H == K:
        assert _excess(jdk, tk.grad) <= 1e-5
    else:
        assert _rel(jdk, tk.grad) <= 1e-2
    # the switch changes the scores: not the fp32 path
    plain = tl._sdpa_seq(*(torch.from_numpy(x) for x in (q, k, v)), causal,
                         window, cap, scale)
    assert not torch.equal(plain, to.detach())


# ---------------------------------------------------------------------------
# the model's paths with sdpa_bf16
# ---------------------------------------------------------------------------

def _both(name, dtype):
    jc, tc = _cfgs(name, dtype, sdpa_bf16=True)
    npp = _params(name)
    return jc, tc, jax.tree.map(jnp.asarray, npp), from_numpy_tree(npp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemma_prefill_dense_and_paged_decode_with_sdpa_bf16_match_jax(dtype):
    """gqa_attention's full sequence (prefill logits and caches), dense
    decode after ``pad_cache`` and the paged plain gather, 3 steps each,
    against the JAX package's (its CPU paged path is the gather); the
    paged kernel's path is called as without the switch (bitwise the
    same as with it off)."""
    jc, tc, jp, tp = _both("gemma", dtype)
    tc_off = dataclasses.replace(tc, sdpa_bf16=False)
    B, S0, steps, bs = 2, 9, 3, 4
    toks = np.random.RandomState(2).randint(0, tc.vocab_size, (B, S0 + steps)
                                            ).astype(np.int32)
    jlog, jcache, _ = jax.jit(partial(jax_forward, cfg=jc, rt=JAX_RT,
                                      mode="prefill"))(jp, tokens=jnp.asarray(toks[:, :S0]))
    rt = Runtime(CPU, paged_kernel=False)
    tlog, tcache = forward(tp, tc, rt, torch.from_numpy(toks[:, :S0]), mode="prefill")
    assert _rel(jlog, tlog) <= SDPA_REL[dtype]
    for name, ref in from_numpy_tree(jax.tree.map(np.asarray, jcache)).items():
        if not name.endswith("slot_pos"):
            assert _rel(ref, tcache[name]) <= SDPA_REL[dtype], name
    nbmax = tpc.n_blocks_for(S0 + steps, bs)
    jdense = jeng.pad_cache(jcache, nbmax * bs - S0)
    dense = teng.pad_cache(tcache, nbmax * bs - S0)
    paged = {}
    for kernel in (False, True):
        paged[kernel] = tpc.paged_cache_init(tc, B, bs, 1 + B * nbmax, nbmax, CPU)
        for row in range(B):
            own = list(range(1 + row * nbmax, 1 + (row + 1) * nbmax))
            tpc.set_block_table(paged[kernel], row, own)
            tpc.splice_prefill(paged[kernel], tcache, row, row, own)
    off = {k: v.clone() for k, v in paged[True].items()}
    jstep_ = jax.jit(partial(jax_forward, cfg=jc, rt=JAX_RT, mode="decode"))
    for i in range(steps):
        feed = toks[:, S0 + i:S0 + i + 1]
        pos = np.full((B,), S0 + i, np.int32)
        jlog, jdense, _ = jstep_(jp, tokens=jnp.asarray(feed), cache=jdense,
                                 pos=jnp.asarray(pos))
        tf, tpos = torch.from_numpy(feed), torch.from_numpy(pos)
        dlog, _ = forward(tp, tc, rt, tf, mode="decode", cache=dense, pos=tpos)
        glog, _ = forward(tp, tc, rt, tf, mode="decode", cache=paged[False], pos=tpos)
        klog, _ = forward(tp, tc, Runtime(CPU), tf, mode="decode",
                          cache=paged[True], pos=tpos)
        kref, _ = forward(tp, tc_off, Runtime(CPU), tf, mode="decode",
                          cache=off, pos=tpos)
        assert _rel(jlog, dlog) <= SDPA_REL[dtype], f"dense step {i}"
        assert _rel(jlog, glog) <= SDPA_REL[dtype], f"paged gather step {i}"
        assert torch.equal(klog, kref), f"paged kernel step {i}"


def test_mla_full_sequence_with_sdpa_bf16_matches_jax_and_absorbed_decode_is_unchanged():
    """deepseek-v2-lite: the prefill (MLA's full sequence) with the
    switch against JAX; the absorbed decode on the dense ring keeps its
    fp32 score products (bitwise the same with the switch off) and
    matches JAX's with it on."""
    jc, tc, jp, tp = _both("dsv2", "float32")
    tc_off = dataclasses.replace(tc, sdpa_bf16=False)
    B, S0, steps = 2, 9, 3
    toks = np.random.RandomState(4).randint(0, tc.vocab_size, (B, S0 + steps)
                                            ).astype(np.int32)
    jlog, jcache, _ = jax.jit(partial(jax_forward, cfg=jc, rt=JAX_RT,
                                      mode="prefill"))(jp, tokens=jnp.asarray(toks[:, :S0]))
    tlog, tcache = forward(tp, tc, Runtime(CPU), torch.from_numpy(toks[:, :S0]),
                           mode="prefill")
    assert _rel(jlog, tlog) <= SDPA_REL["float32"]
    jdense = jeng.pad_cache(jcache, steps)
    dense = teng.pad_cache(tcache, steps)
    dense_off = {k: v.clone() for k, v in dense.items()}
    jstep_ = jax.jit(partial(jax_forward, cfg=jc, rt=JAX_RT, mode="decode"))
    for i in range(steps):
        feed = toks[:, S0 + i:S0 + i + 1]
        pos = np.full((B,), S0 + i, np.int32)
        jlog, jdense, _ = jstep_(jp, tokens=jnp.asarray(feed), cache=jdense,
                                 pos=jnp.asarray(pos))
        tf, tpos = torch.from_numpy(feed), torch.from_numpy(pos)
        on, _ = forward(tp, tc, Runtime(CPU), tf, mode="decode", cache=dense, pos=tpos)
        off, _ = forward(tp, tc_off, Runtime(CPU), tf, mode="decode",
                         cache=dense_off, pos=tpos)
        assert _rel(jlog, on) <= SDPA_REL["float32"], f"step {i}"
        assert torch.equal(on, off), f"step {i}"


def test_whisper_encoder_and_cross_attention_with_sdpa_bf16_match_jax():
    """The encoder's bidirectional self-attention, ``_cross_attend`` and
    the prefill logits (decoder self-attention too), fp32 compute."""
    jc, tc, jp, tp = _both("whisper", "float32")
    r = np.random.RandomState(5)
    frames = r.randn(2, tc.encoder_len, tc.d_model).astype(np.float32)
    jenc = jt.encode(jp, jc, JAX_RT, jnp.asarray(frames))
    tenc = tt.encode(tp, tc, Runtime(CPU), torch.from_numpy(frames))
    assert _rel(jenc, tenc) <= SDPA_REL["float32"]
    x = r.randn(2, 6, tc.d_model).astype(np.float32)
    jcross = jp["blocks"]["L0"]["cross"]
    jck, jcv = jt._cross_kv(jax.tree.map(lambda a: a[0], jcross), jenc, jc)
    jo = jt._cross_attend(jax.tree.map(lambda a: a[0], jcross), jnp.asarray(x),
                          jc, jck, jcv)
    tcross = {k[len("blocks.L0.cross."):]: v[0] for k, v in tp.items()
              if k.startswith("blocks.L0.cross.")}
    tck, tcv = tt._cross_kv(tcross, torch.from_numpy(np.asarray(jenc)), tc)
    to = tt._cross_attend(tcross, torch.from_numpy(x), tc, tck, tcv)
    assert _rel(jo, to) <= SDPA_REL["float32"]
    toks = r.randint(0, tc.vocab_size, (2, 8)).astype(np.int32)
    jlog, _, _ = jax_forward(jp, jc, JAX_RT, jnp.asarray(toks), mode="prefill",
                             encoder_embeds=jnp.asarray(frames))
    tlog, _ = forward(tp, tc, Runtime(CPU), torch.from_numpy(toks), mode="prefill",
                      encoder_embeds=torch.from_numpy(frames))
    assert _rel(jlog, tlog) <= SDPA_REL["float32"]


# ---------------------------------------------------------------------------
# loss_fn and every gradient with each switch
# ---------------------------------------------------------------------------

SWITCHES = {"logits_bf16": ({"logits_bf16": True}, "float32"),
            "sdpa_bf16": ({"sdpa_bf16": True}, "float32"),
            "gather_dtype": ({}, "bfloat16"),
            "all": ({"logits_bf16": True, "sdpa_bf16": True}, "bfloat16")}


def _loss_and_grads(name, dtype, switch, remat=False):
    kw, gather = SWITCHES[switch]
    jc, tc = _cfgs(name, dtype, **kw)
    npp = _params(name)
    batch = _batch(name, tc)
    jrt = dataclasses.replace(JAX_RT, gather_dtype=gather)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        partial(jstep.loss_fn, cfg=jc, rt=jrt), has_aux=True))(
        jax.tree.map(jnp.asarray, npp), jax.tree.map(jnp.asarray, batch))
    tp = {k: v.requires_grad_() for k, v in from_numpy_tree(npp).items()}
    tloss, _ = tstep.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                             tc, Runtime(CPU, remat=remat, gather_dtype=gather))
    tloss.backward()
    want = from_numpy_tree(jax.tree.map(np.asarray, jg))
    return float(jloss), float(tloss.detach()), want, {k: v.grad for k, v in tp.items()}


@pytest.mark.parametrize("switch", SWITCHES)
@pytest.mark.parametrize("name", ["gemma", "whisper", "dsv2"])
def test_loss_and_every_gradient_match_jax_with_each_switch(name, switch):
    jloss, tloss, want, got = _loss_and_grads(name, "float32", switch)
    assert abs(tloss - jloss) <= REL["float32"] * abs(jloss)
    assert set(want) == set(got)
    for k, g in want.items():
        assert got[k].dtype == torch.float32, k
        assert _excess(g, got[k]) <= GRAD_EXCESS[switch], k


def test_loss_and_every_gradient_match_jax_with_all_switches_at_bf16_compute():
    jloss, tloss, want, got = _loss_and_grads("gemma", "bfloat16", "all")
    assert abs(tloss - jloss) <= REL["bfloat16"] * abs(jloss)
    for k, g in want.items():
        assert _rel(g, got[k]) <= REL["bfloat16"], k


def _meta_params(defs):
    return {k: torch.empty(d.shape, dtype=d.dtype, device="meta")
            for k, d in flatten_defs(defs).items()}


@pytest.mark.parametrize("arch", sorted(jcfg.ARCHS))
def test_gather_dtype_casts_the_reference_rules_leaves(arch, monkeypatch):
    """At full width, abstractly: the leaves the reference's ``loss_fn``
    hands its ``forward`` in bf16 (read by a stand-in ``forward`` under
    ``jax.eval_shape``) are the ones ``gather_cast`` casts, the stacked
    norm scales, Mamba2's ``A_log`` and the embedding among them."""
    jc = jcfg.ARCHS[arch]
    seen = {}

    class Seen(Exception):
        pass

    def fake_forward(params, *a, **kw):
        seen.update(from_numpy_tree(jax.tree.map(
            lambda x: np.zeros((), x.dtype), params)))
        raise Seen

    monkeypatch.setattr(jstep, "forward", fake_forward)
    defs = jax_model_defs(jc)
    shapes = jax.tree.map(lambda d: jax.ShapeDtypeStruct(d.shape, d.dtype), defs,
                          is_leaf=is_def)
    batch = {"tokens": jax.ShapeDtypeStruct((1, 8), jnp.int32),
             "loss_mask": jax.ShapeDtypeStruct((1, 8), jnp.float32)}
    with pytest.raises(Seen):
        jax.eval_shape(partial(jstep.loss_fn, cfg=jc, rt=dataclasses.replace(
            JAX_RT, gather_dtype="bfloat16")), shapes, batch)
    stored = _meta_params(model_defs(tcfg.ARCHS[arch]))
    cast = tstep.gather_cast(stored, Runtime(CPU, gather_dtype="bfloat16"))
    want = {k for k, v in seen.items() if v.dtype == torch.bfloat16
            and stored[k].dtype == torch.float32}
    got = {k for k, v in cast.items() if v.dtype != stored[k].dtype}
    assert set(seen) == set(stored) and got == want
    assert tstep.gather_cast(stored, Runtime(CPU)) is stored
    if jc.param_dtype == "float32":
        assert "embed" in got and "final_norm.scale" not in got
        assert any(k.endswith("_norm.scale") or k.endswith(".A_log") for k in got)


# ---------------------------------------------------------------------------
# sqrt-remat grouping
# ---------------------------------------------------------------------------

def test_remat_group_is_the_reference_rule():
    assert ([tt._remat_group(n) for n in range(1, 201)]
            == [jt._remat_group(n) for n in range(1, 201)])
    assert [tt._remat_group(n) for n in (11, 12, 13, 18, 23, 32, 48)] == \
        [1, 3, 4, 4, 5, 6, 7]


def _true_fan_in(tc, npp, seed):
    """The numpy tree with every stacked matrix (a "normal" leaf of 3+
    dims at the default scale) redrawn at 1/sqrt(its true fan-in): the
    reference init reads a stacked leaf's fan-in from its layer axis."""
    from repro_torch.models.param import _fan_in
    r = np.random.RandomState(seed)
    flat = from_numpy_tree(npp)
    for path, d in flatten_defs(model_defs(tc)).items():
        if (d.init == "normal" and d.scale < 0 and len(d.shape) >= 3
                and d.axes[0] == "layers"):
            one = d._replace(shape=d.shape[1:], axes=d.axes[1:])
            flat[path] = torch.from_numpy(np.asarray(
                r.randn(*d.shape) / np.sqrt(_fan_in(one)), np.float32))
    return to_numpy_tree(flat)


# (smoke model, n_layers, gradient bound against JAX, of each leaf's
# max): 12, 13 and 18 periods give groups of 3, 4, 4 (13 and 18 leave 1
# and 2 periods ungrouped); whisper groups its 12 decoder periods, not
# its encoder; deepseek-v2-lite (one dense prefix layer, 12 MoE periods)
# carries the aux loss through the groups.  The MoE and SSM stacks are
# held to 1e-4, not the fp32 bound 2e-5: at 12 layers their fp32
# differences from JAX reach 2.2e-5 (dsv2's prefix wk_b) and 3.0e-5
# (mamba2's A_log) with grouping and without it alike
GROUPED = {"gemma-12": ("gemma", 12, 2e-5), "gemma-13": ("gemma", 13, 2e-5),
           "gemma-18": ("gemma", 18, 2e-5), "whisper-12": ("whisper", 12, 2e-5),
           "dsv2-13": ("dsv2", 13, 1e-4), "mamba2-12": ("mamba2", 12, 1e-4)}


@pytest.mark.parametrize("case", GROUPED)
def test_grouped_remat_gradients_bitwise_per_block_and_match_jax(case, monkeypatch):
    """fp32 compute, remat on: grouped gradients (and the loss and aux
    loss) bitwise the per-block ones (``_remat_group`` forced to 1), and
    within ``GROUPED``'s bound of the JAX package's grouped remat."""
    name, n_layers, bound = GROUPED[case]
    kw = {"n_layers": n_layers}
    jc, tc = _cfgs(name, "float32")
    if name == "dsv2":
        kw["moe"] = dataclasses.replace(tc.moe, n_dense_prefix=1)
    jc, tc = (dataclasses.replace(c, **kw) for c in (jc, tc))
    assert tt._remat_group(tt.layer_pattern(tc)[2]) > 1
    npp = _true_fan_in(tc, jax.tree.map(np.asarray, jax_materialize(
        jax_model_defs(jc), jax.random.PRNGKey(0))), n_layers)
    batch = _batch(name, tc, S=16, seed=n_layers)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(partial(
        jstep.loss_fn, cfg=jc, rt=dataclasses.replace(JAX_RT, remat=True)),
        has_aux=True))(jax.tree.map(jnp.asarray, npp),
                       jax.tree.map(jnp.asarray, batch))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads, stats = {}, {}
    for grouped in (True, False):
        if not grouped:
            monkeypatch.setattr(tt, "_remat_group", lambda n: 1)
        tp = {k: v.requires_grad_() for k, v in from_numpy_tree(npp).items()}
        loss, m = tstep.loss_fn(tp, tb, tc, Runtime(CPU, remat=True))
        loss.backward()
        grads[grouped] = {k: v.grad for k, v in tp.items()}
        stats[grouped] = (loss.detach(), m["aux_loss"].detach())
    assert all(torch.equal(a, b) for a, b in zip(stats[True], stats[False]))
    assert abs(float(stats[True][0]) - float(jloss)) <= 2e-5 * abs(float(jloss))
    if name == "dsv2":
        assert float(stats[True][1]) > 0
        assert abs(float(stats[True][1]) - float(jm["aux_loss"])) <= \
            1e-6 * abs(float(jm["aux_loss"]))
    for k, g in from_numpy_tree(jax.tree.map(np.asarray, jg)).items():
        assert torch.equal(grads[True][k], grads[False][k]), k
        assert _rel(g, grads[True][k]) <= bound, k


def test_save_tp_raises_and_the_defaults_are_the_references():
    with pytest.raises(NotImplementedError, match="Queue A item 5"):
        Runtime(CPU, remat_policy="save_tp")
    rt, jrt = Runtime(CPU), JaxRuntime()
    assert (rt.gather_dtype, rt.remat_policy) == (jrt.gather_dtype, jrt.remat_policy)
