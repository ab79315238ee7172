"""The PyTorch port's configs, parameters and model forward against the
JAX package.

The weights are the JAX package's own, ``materialize(model_defs(cfg),
PRNGKey(0))``, carried across by ``repro_torch.convert``; tokens come
from numpy with a seed.  Bounds, on logits and on the K/V caches,
relative to the largest magnitude of the JAX package's output:

  * ``compute_dtype="float32"``: 5e-5.  fp32 matmuls are summed in
    other orders by XLA and by PyTorch's CPU kernels, and the reference
    init draws stacked weights at fan-in n_layers, so activations grow
    to tens inside the stack and few-ulp differences grow with them;
  * the default bf16 compute: 5e-2 (bf16 rounds at other places in the
    two frameworks, e.g. inside GELU and the matmul epilogues).
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
from repro.models.param import count as jax_count
from repro.models.param import is_def, materialize as jax_materialize
from repro.serving import paged_cache as jpc
from repro_torch import configs as tcfg
from repro_torch import prng
from repro_torch.convert import from_numpy_tree
from repro_torch.models import (CPU_RUNTIME, Runtime, cast_for_compute, count,
                                forward, materialize, model_defs)
from repro_torch.models import layers as tl
from repro_torch.models.param import flatten_defs
from repro_torch.serving import paged_cache as tpc

DENSE = ["deepseek-7b", "yi-9b", "gemma-2b", "gemma2-27b", "chameleon-34b"]
UNPORTED = ["deepseek-v2-236b", "deepseek-v2-lite-16b", "whisper-large-v3",
            "mamba2-1.3b", "jamba-1.5-large-398b"]
# gemma-2b (the slice's model), gemma2-27b (window, local/global, both
# softcaps) and chameleon-34b (QK-norm)
PARITY = ["gemma-2b", "gemma2-27b", "chameleon-34b"]
REL = {"float32": 5e-5, "bfloat16": 5e-2}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype):
    j = dataclasses.replace(jcfg.smoke_variant(jcfg.ARCHS[arch]), compute_dtype=dtype)
    t = dataclasses.replace(tcfg.smoke_variant(tcfg.ARCHS[arch]), compute_dtype=dtype)
    return j, t


_PARAMS = {}


def _params(arch):
    """The JAX package's smoke params and the same bits in the port."""
    if arch not in _PARAMS:
        jc, _ = _cfgs(arch, "float32")
        jp = jax_materialize(jax_model_defs(jc), jax.random.PRNGKey(0))
        tp = from_numpy_tree(jax.tree.map(np.asarray, jp))
        _PARAMS[arch] = (jp, tp)
    return _PARAMS[arch]


def _rel_err(ref, got):
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    return np.max(np.abs(ref - got)) / max(1e-30, np.max(np.abs(ref)))


# ---------------------------------------------------------------------------
# configs and parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(jcfg.ARCHS))
def test_configs_are_copies_of_the_jax_configs(arch):
    j, t = jcfg.ARCHS[arch], tcfg.ARCHS[arch]
    for a, b in ((j, t), (jcfg.smoke_variant(j), tcfg.smoke_variant(t))):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        pa, pb = jcfg.layer_pattern(a), tcfg.layer_pattern(b)
        assert [[dataclasses.astuple(s) for s in part] for part in pa[:2]] == \
            [[dataclasses.astuple(s) for s in part] for part in pb[:2]]
        assert pa[2] == pb[2]
        assert a.param_count() == b.param_count()


@pytest.mark.parametrize("arch", DENSE)
def test_model_defs_match_jax(arch):
    """Same dotted paths, shapes, logical axes, inits and scales, and so
    the same parameter count (gemma-2b: 2,506,172,416)."""
    jd = jax_model_defs(jcfg.ARCHS[arch])
    td = model_defs(tcfg.ARCHS[arch])
    flat = jax.tree_util.tree_flatten_with_path(jd, is_leaf=is_def)[0]
    jflat = {".".join(str(k.key) for k in path): d for path, d in flat}
    tflat = flatten_defs(td)
    assert sorted(jflat) == sorted(tflat)
    for k, d in jflat.items():
        e = tflat[k]
        assert (d.shape, d.axes, d.init, d.scale) == (e.shape, e.axes, e.init, e.scale), k
    assert count(td) == jax_count(jd)
    if arch == "gemma-2b":
        assert count(td) == 2_506_172_416


@pytest.mark.parametrize("arch", UNPORTED)
def test_model_defs_raise_for_unported_stacks(arch):
    """Every stack once refused here is ported since (MLA and MoE, the
    DeepSeek-V2 stacks; the pure Mamba2 stack; the jamba hybrid; the
    Whisper encoder-decoder): the tree is the JAX package's, path for
    path, with its shapes and dtypes."""
    jd = jax_model_defs(jcfg.ARCHS[arch])
    flat = jax.tree_util.tree_flatten_with_path(jd, is_leaf=is_def)[0]
    jflat = {".".join(str(k.key) for k in path): d for path, d in flat}
    tflat = flatten_defs(model_defs(tcfg.ARCHS[arch]))
    assert sorted(jflat) == sorted(tflat)
    for k, d in jflat.items():
        e = tflat[k]
        assert d.shape == e.shape, k
        assert np.dtype(d.dtype).name == str(e.dtype).removeprefix("torch."), k
    if tcfg.ARCHS[arch].is_pure_ssm:
        assert len(tflat) == 15 and count(model_defs(tcfg.ARCHS[arch])) \
            == 1_343_740_928
    elif tcfg.ARCHS[arch].ssm is not None:     # jamba: every leaf bf16
        assert len(tflat) == 135 and count(model_defs(tcfg.ARCHS[arch])) \
            == 397_711_939_584
        assert {e.dtype for e in tflat.values()} == {torch.bfloat16}
    elif tcfg.ARCHS[arch].is_encoder_decoder:  # whisper: encoder + cross
        assert len(tflat) == 35 and count(model_defs(tcfg.ARCHS[arch])) \
            == 1_535_219_200
        assert "encoder.blocks.L0.attn.wq" in tflat
        assert "blocks.L0.cross.wq" in tflat


def test_materialize_is_seeded_and_follows_the_jax_scales():
    _, cfg = _cfgs("gemma-2b", "float32")
    defs = model_defs(cfg)

    def draw(seed):
        return materialize(defs, prng.PRNGKey(seed), torch.device("cpu"))
    a, b, c = draw(0), draw(0), draw(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    jp, tp = _params("gemma-2b")
    for k in tp:                     # same shapes, dtypes, and scale per leaf
        assert a[k].shape == tp[k].shape and a[k].dtype == tp[k].dtype, k
        ref_std = float(tp[k].std()) if tp[k].numel() > 1 else 0.0
        if ref_std > 0:
            assert abs(float(a[k].std()) / ref_std - 1) < 0.1, k


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_jax(dtype):
    jc, tc = _cfgs("gemma-2b", dtype)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 4, 64).astype(np.float32)
    pos = rng.randint(0, 300, (2, 5)).astype(np.int32)
    scale = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tol = 1e-6 if dtype == "float32" else 1e-2
    assert _rel_err(jl.rope(jx, jnp.asarray(pos), 10000.0),
                    tl.rope(tx, torch.from_numpy(pos), 10000.0)) <= tol
    assert _rel_err(jl.rmsnorm({"scale": jnp.asarray(scale)}, jx),
                    tl.rmsnorm(torch.from_numpy(scale), tx)) <= tol
    assert _rel_err(jl.softcap(jx, 5.0), tl.softcap(tx, 5.0)) <= tol
    w = {k: rng.randn(*s).astype(np.float32) * 0.1 for k, s in
         (("wg", (64, 96)), ("wu", (64, 96)), ("wd", (96, 64)))}
    j_mlp = jl.mlp({k: jnp.asarray(v) for k, v in w.items()}, jx,
                   dataclasses.replace(jc, d_model=64))
    t_mlp = tl.mlp({k: torch.from_numpy(v) for k, v in w.items()}, tx,
                   dataclasses.replace(tc, d_model=64))
    assert _rel_err(j_mlp, t_mlp) <= (1e-5 if dtype == "float32" else 2e-2)


# ---------------------------------------------------------------------------
# forward: prefill (with last_pos) and paged decode
# ---------------------------------------------------------------------------

def _prompts(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", PARITY)
def test_prefill_matches_jax(arch, dtype):
    jc, tc = _cfgs(arch, dtype)
    jp, tp = _params(arch)
    toks = _prompts(tc, 3, 12, seed=1)
    last = np.array([11, 4, 7], np.int32)
    jl_, jcache, _ = jax.jit(partial(jax_forward, cfg=jc, rt=JAX_RT, mode="prefill"))(
        jp, tokens=jnp.asarray(toks), last_pos=jnp.asarray(last))
    tl_, tcache = forward(tp, tc, CPU_RUNTIME, torch.from_numpy(toks),
                          mode="prefill", last_pos=torch.from_numpy(last))
    assert tuple(tl_.shape) == jl_.shape == (3, 1, tc.vocab_size)
    assert _rel_err(jl_, tl_) <= REL[dtype]
    # the dense cache the scheduler splices into the pool
    for j, name in enumerate(sorted(jcache["blocks"])):
        for leaf in ("k", "v", "slot_pos"):
            ref = jcache["blocks"][name]["attn"][leaf]
            got = tcache[f"blocks.{name}.attn.{leaf}"]
            assert tuple(got.shape) == ref.shape
            if leaf == "slot_pos":
                np.testing.assert_array_equal(np.asarray(ref), got.numpy())
            else:
                assert _rel_err(ref, got) <= REL[dtype]


def _paged_pair(jc, tc, jdense, tdense, B, bs, nbmax, n_blocks):
    """The same block tables and prefill rows in a JAX and a port pool."""
    jpaged = jpc.paged_cache_init(jc, B, bs, n_blocks, nbmax)
    tpaged = tpc.paged_cache_init(tc, B, bs, n_blocks, nbmax, torch.device("cpu"))
    ids = np.random.RandomState(2).permutation(np.arange(1, n_blocks))
    for row in range(B):
        own = [int(b) for b in ids[row * nbmax:(row + 1) * nbmax]]
        jpaged = jpc.set_block_table(jpaged, row, own)
        jpaged = jpc.splice_prefill(jpaged, jdense, row, row, own)
        tpc.set_block_table(tpaged, row, own)
        tpc.splice_prefill(tpaged, tdense, row, row, own)
    return jpaged, tpaged


@pytest.mark.parametrize("paged_kernel", [True, False], ids=["ops", "gather"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", PARITY)
def test_paged_decode_matches_jax(arch, dtype, paged_kernel):
    """Prefill, splice into pools through the same block tables, then
    teacher-forced decode steps: logits against the JAX ``forward``'s
    paged decode (its gather path, as it runs on the CPU).  ``ops``
    routes attention through the kernel wrapper (its plain version on
    the CPU), ``gather`` through the model's gather path."""
    jc, tc = _cfgs(arch, dtype)
    jp, tp = _params(arch)
    rt = Runtime(device=torch.device("cpu"), paged_kernel=paged_kernel)
    B, S0, bs, steps = 3, 9, 4, 4
    nbmax = tpc.n_blocks_for(S0 + steps, bs)
    toks = _prompts(tc, B, S0, seed=3)
    _, jdense, _ = jax.jit(partial(jax_forward, cfg=jc, rt=JAX_RT, mode="prefill"))(
        jp, tokens=jnp.asarray(toks))
    _, tdense = forward(tp, tc, rt, torch.from_numpy(toks), mode="prefill")
    jpaged, tpaged = _paged_pair(jc, tc, jdense, tdense, B, bs, nbmax, 3 * B * nbmax)
    jstep = jax.jit(partial(jax_forward, cfg=jc, rt=JAX_RT, mode="decode"))
    feed = _prompts(tc, steps, B, seed=4)
    for i in range(steps):
        pos = np.full((B,), S0 + i, np.int32)
        jlog, jpaged, _ = jstep(jp, tokens=jnp.asarray(feed[i][:, None]),
                                cache=jpaged, pos=jnp.asarray(pos))
        tlog, tpaged = forward(tp, tc, rt, torch.from_numpy(feed[i][:, None]),
                               mode="decode", cache=tpaged, pos=torch.from_numpy(pos))
        assert _rel_err(jlog, tlog) <= REL[dtype], f"step {i}"
    for name in jpaged["blocks"]:                   # the pools agree too
        for leaf in ("kp", "vp"):
            assert _rel_err(jpaged["blocks"][name]["attn"][leaf],
                            tpaged[f"blocks.{name}.attn.{leaf}"]) <= REL[dtype]


def test_cast_once_equals_cast_at_use():
    """``cast_for_compute`` gives the same bits as casting at every use."""
    _, tc = _cfgs("gemma-2b", "bfloat16")
    _, tp = _params("gemma-2b")
    toks = torch.from_numpy(_prompts(tc, 2, 6, seed=5))
    a, _ = forward(tp, tc, CPU_RUNTIME, toks, mode="prefill")
    cast = cast_for_compute(tp, tc)
    assert cast["blocks.L0.attn.wq"].dtype == torch.bfloat16
    assert cast["embed"].dtype == torch.float32
    b, _ = forward(cast, tc, CPU_RUNTIME, toks, mode="prefill")
    assert torch.equal(a, b)
