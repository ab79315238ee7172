"""The port's multi-head latent attention (DeepSeek-V2's MLA) against
the JAX package: the attention layer in its three modes (full sequence
with decompressed K/V, absorbed decode on the dense ring, absorbed
decode through the paged latent pools), and the same forms through the
whole model for both smoke variants (deepseek-v2-lite-16b: no query
compression; deepseek-v2-236b: ``q_lora_rank`` > 0) and a 3-layer
lite variant whose first layer is a dense prefix layer.

Layer weights are the JAX package's ``materialize(attention_defs)``,
model weights its ``materialize(model_defs)`` (``PRNGKey(0)``), both
carried across by ``repro_torch.convert``; inputs and tokens come from
numpy with a seed; compute is fp32.  Bounds, relative to the largest
magnitude of the reference:

  * port against the JAX package (outputs, logits, the latent caches):
    5e-5, the model tests' fp32 bound (XLA and PyTorch's CPU kernels
    sum fp32 matmuls in other orders); ``slot_pos`` equal;
  * port decode against a teacher-forced port prefill of the prefix:
    5e-5 (absorbed against decompressed attention: other products,
    other orders).  MoE capacity is raised to 16 there, as the JAX
    package's ``tests/test_decode.py`` does: a prefill of S + i tokens
    and a decode step of B tokens have other capacities, so the
    reference itself drops other assignments in the two;
  * dense ring decode against paged decode at matched geometry (dense
    context = nbmax x block size): bitwise, at the config's capacity.
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
from repro.models.param import materialize as jax_materialize
from repro.serving import engine as jeng
from repro_torch import configs as tcfg
from repro_torch.convert import from_numpy_tree
from repro_torch.models import CPU_RUNTIME, forward
from repro_torch.models import layers as tl
from repro_torch.serving import engine as teng
from repro_torch.serving import paged_cache as tpc

REL = 5e-5
CPU = torch.device("cpu")
VARIANTS = ["lite", "236b", "lite-prefix"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(variant, cf=None, window=0):
    arch = "deepseek-v2-236b" if variant == "236b" else "deepseek-v2-lite-16b"
    out = []
    for mod in (jcfg, tcfg):
        c = dataclasses.replace(mod.smoke_variant(mod.ARCHS[arch]),
                                compute_dtype="float32", window=window)
        moe = c.moe
        if variant == "lite-prefix":
            moe = dataclasses.replace(moe, n_dense_prefix=1)
            c = dataclasses.replace(c, n_layers=3)
        if cf is not None:
            moe = dataclasses.replace(moe, capacity_factor=cf)
        out.append(dataclasses.replace(c, moe=moe))
    return out


def _rel(ref, got):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return np.max(np.abs(ref - got)) / max(1e-30, np.max(np.abs(ref)))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# the attention layer, three modes
# ---------------------------------------------------------------------------

def _layer(variant, window=0):
    jc, tc = _cfgs(variant, window=window)
    jp = jax_materialize(jl.attention_defs(jc), jax.random.PRNGKey(0))
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp))
    assert sorted(tp) == sorted(tl.attention_defs(tc))
    for k, d in tl.attention_defs(tc).items():
        assert tuple(tp[k].shape) == d.shape, k
    return jc, tc, jp, tp


def _x(d, B, S, seed):
    return np.asarray(np.random.RandomState(seed).randn(B, S, d), np.float32)


@pytest.mark.parametrize("variant,window", [("lite", 0), ("236b", 0), ("lite", 8)],
                         ids=["lite", "236b", "lite-window-rotated"])
def test_full_sequence_matches_jax(variant, window):
    """S 12: with a window of 8 the latent cache is a rotated ring."""
    jc, tc, jp, tp = _layer(variant, window)
    B, S = 2, 12
    x = _x(tc.d_model, B, S, 1)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jo, jcache = jax.jit(partial(jl.mla_attention, cfg=jc, local=window > 0))(
        jp, jnp.asarray(x), pos=jnp.asarray(pos))
    to, tcache = tl.mla_attention(tp, torch.from_numpy(x), tc, local=window > 0,
                                  pos=torch.from_numpy(pos.copy()))
    assert _rel(jo, to) <= REL
    assert sorted(jcache) == sorted(tcache) == ["ckv", "krope", "slot_pos"]
    Sc = min(S, window) if window else S
    assert tuple(tcache["ckv"].shape) == (B, Sc, tc.mla.kv_lora_rank)
    for k in ("ckv", "krope"):
        assert _rel(jcache[k], tcache[k]) <= REL, k
    assert np.array_equal(np.asarray(jcache["slot_pos"]), tcache["slot_pos"].numpy())
    _, none = tl.mla_attention(tp, torch.from_numpy(x), tc, local=False,
                               pos=torch.from_numpy(pos.copy()), build_cache=False)
    assert none is None


def _pool_from(cache_leaf, bt, n_blocks, bs):
    """A latent pool (n_blocks, bs, r) holding ``cache_leaf`` (B, S, r)
    through the block table ``bt`` (B, nbmax)."""
    B, S = cache_leaf.shape[:2]
    pool = np.zeros((n_blocks, bs) + cache_leaf.shape[2:], np.float32)
    for b in range(B):
        for t in range(S):
            pool[bt[b, t // bs], t % bs] = cache_leaf[b, t]
    return pool


@pytest.mark.parametrize("variant", ["lite", "236b"])
def test_dense_and_paged_decode_match_jax(variant):
    """Prefill 9 positions, then 4 absorbed decode steps on the dense
    ring (padded to 16) and through the latent pools (block size 4,
    nbmax 4): each step's output against the JAX package's dense decode,
    the two port paths bitwise, and the written caches."""
    jc, tc, jp, tp = _layer(variant)
    B, S0, steps, bs = 2, 9, 4, 4
    nbmax = tpc.n_blocks_for(S0 + steps, bs)
    xs = _x(tc.d_model, B, S0 + steps, 2)
    pos0 = np.broadcast_to(np.arange(S0, dtype=np.int32), (B, S0))
    jmla = jax.jit(partial(jl.mla_attention, cfg=jc, local=False))
    _, jcache = jmla(jp, jnp.asarray(xs[:, :S0]), pos=jnp.asarray(pos0))
    _, tcache = tl.mla_attention(tp, torch.from_numpy(xs[:, :S0].copy()), tc,
                                 local=False, pos=torch.from_numpy(pos0.copy()))
    jcache = jeng.pad_cache(jcache, nbmax * bs - S0)
    dense = teng.pad_cache(tcache, nbmax * bs - S0)
    bt = np.arange(1, 1 + B * nbmax, dtype=np.int32).reshape(B, nbmax)[:, ::-1].copy()
    paged = {"ckvp": torch.from_numpy(_pool_from(tcache["ckv"].numpy(), bt, 1 + B * nbmax, bs)),
             "kropep": torch.from_numpy(_pool_from(tcache["krope"].numpy(), bt, 1 + B * nbmax, bs)),
             "bt": torch.from_numpy(bt)}
    for i in range(steps):
        x1 = xs[:, S0 + i:S0 + i + 1].copy()
        pos = np.full((B,), S0 + i, np.int32)
        jo, jcache = jmla(jp, jnp.asarray(x1), pos=jnp.asarray(pos), cache=jcache)
        do, d2 = tl.mla_attention(tp, torch.from_numpy(x1), tc, local=False,
                                  pos=torch.from_numpy(pos), cache=dense)
        po, p2 = tl.mla_attention(tp, torch.from_numpy(x1), tc, local=False,
                                  pos=torch.from_numpy(pos), cache=paged)
        assert d2 is dense and p2 is paged                  # written in place
        assert _rel(jo, do) <= REL, f"step {i}"
        assert torch.equal(do, po), f"step {i}: dense vs paged"
    for k in ("ckv", "krope"):
        assert _rel(jcache[k], dense[k]) <= REL, k
        gathered = tl._paged_gather(paged[k + "p"], paged["bt"])
        assert torch.equal(gathered[:, :S0 + steps], dense[k][:, :S0 + steps]), k
    assert np.array_equal(np.asarray(jcache["slot_pos"]), dense["slot_pos"].numpy())


# ---------------------------------------------------------------------------
# through the model: decode against teacher forcing and JAX, paged == dense
# ---------------------------------------------------------------------------

_MODEL = {}


def _model(variant):
    if variant not in _MODEL:
        jc, _ = _cfgs(variant)
        jp = jax_materialize(jax_model_defs(jc), jax.random.PRNGKey(0))
        _MODEL[variant] = (jp, from_numpy_tree(jax.tree.map(np.asarray, jp)))
    return _MODEL[variant]


def _tokens(vocab, B, S, seed):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("variant", VARIANTS)
def test_model_dense_decode_matches_jax_and_teacher_forcing(variant):
    """Prompt 10, 2 steps, capacity 16 (module docstring)."""
    jc, tc = _cfgs(variant, cf=16.0)
    jp, tp = _model(variant)
    B, S, steps = 2, 10, 2
    toks = _tokens(tc.vocab_size, B, S + steps, 3)
    _, jcache, _ = jax.jit(partial(jax_forward, cfg=jc, rt=JAX_RT, mode="prefill"))(
        jp, tokens=jnp.asarray(toks[:, :S]))
    _, tcache = forward(tp, tc, CPU_RUNTIME, torch.from_numpy(toks[:, :S]), mode="prefill")
    if variant == "lite-prefix":
        assert "prefix.P0.attn.ckv" in tcache and tcache["prefix.P0.attn.ckv"].dim() == 3
    jcache, tcache = jeng.pad_cache(jcache, steps), teng.pad_cache(tcache, steps)
    jstep = jax.jit(partial(jax_forward, cfg=jc, rt=JAX_RT, mode="decode"))
    for i in range(steps):
        pos = np.full((B,), S + i, np.int32)
        feed = toks[:, S + i:S + i + 1]
        jlog, jcache, _ = jstep(jp, tokens=jnp.asarray(feed), cache=jcache,
                                pos=jnp.asarray(pos))
        tlog, _ = forward(tp, tc, CPU_RUNTIME, torch.from_numpy(feed), mode="decode",
                          cache=tcache, pos=torch.from_numpy(pos))
        ref, _ = forward(tp, tc, CPU_RUNTIME, torch.from_numpy(toks[:, :S + i + 1]),
                         mode="prefill")
        assert _rel(jlog, tlog) <= REL, f"step {i} vs JAX"
        assert _rel(ref.numpy(), tlog) <= REL, f"step {i} vs teacher forcing"
    jflat = _flat(jcache)
    assert sorted(jflat) == sorted(tcache)
    for name, ref in jflat.items():
        if name.endswith("slot_pos"):
            assert np.array_equal(ref, tcache[name].numpy()), name
        else:
            assert _rel(ref, tcache[name]) <= REL, name


@pytest.mark.parametrize("variant", VARIANTS)
def test_model_paged_decode_bitwise_matches_dense(variant):
    """The config's capacity (1.25); prompt 9, 6 steps, block size 4:
    the latent pools (the prefix layer's without a period dim) against
    the dense ring at the gathered length, bitwise, and the paged path
    never reaches the paged-attention kernel."""
    _, tc = _cfgs(variant)
    _, tp = _model(variant)
    B, S0, max_new, bs = 2, 9, 7, 4
    prompt = torch.from_numpy(_tokens(tc.vocab_size, B, S0, 0))
    nbmax = tpc.n_blocks_for(S0 + max_new, bs)
    prefill = teng.make_prefill_step(tc, CPU_RUNTIME)
    step = teng.make_serve_step(tc, CPU_RUNTIME)      # paged_kernel=True
    logits, dense = prefill(tp, prompt)
    paged = tpc.paged_cache_init(tc, B, bs, 32, nbmax, CPU)
    assert sorted(k.rsplit(".", 1)[-1] for k in paged) == sorted(
        ["bt", "ckvp", "kropep"] * (2 if variant == "lite-prefix" else 1))
    alloc = tpc.BlockAllocator(32, bs)
    for row in range(B):
        ids = [alloc.alloc() for _ in range(nbmax)]
        tpc.set_block_table(paged, row, ids)
        tpc.splice_prefill(paged, dense, row, row, ids)
    dense = teng.pad_cache(dense, nbmax * bs - S0)
    from repro_torch import kernels
    kernels.reset_launches()
    calls = dict(kernels.CALLS)
    tok_d = tok_p = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    pos = torch.full((B,), S0, dtype=torch.int32)
    for i in range(max_new - 1):
        tok_d, ld, dense = step(tp, dense, tok_d[:, None], pos)
        tok_p, lp, paged = step(tp, paged, tok_p[:, None], pos)
        assert torch.equal(ld, lp), f"{variant} step {i}"
        pos = pos + 1
    assert kernels.CALLS["paged_decode_attention"] == calls["paged_decode_attention"]
