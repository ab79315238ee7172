"""The PyTorch port's dense serving engine against the JAX package: the
ring-buffer rotation, dense (ring) decode, ``pad_cache``,
``cache_abstract`` / ``cache_batch_axes``, ``greedy_generate``, the
``ContinuousBatcher``, ``--engine dense`` and the two examples that
call them.

Weights (and, where a test starts from the JAX package's prefill, its
caches) are the JAX package's smoke params carried across by
``repro_torch.convert.from_numpy_tree``, at ``compute_dtype="float32"``.
Bounds, relative to the largest magnitude of the JAX package's logits:
5e-5, the model tests' fp32 bound (``tests/test_torch_model.py``: XLA
and PyTorch's CPU kernels sum fp32 matmuls in other orders).  Where the
port is held against itself (dense decode vs teacher-forced prefill of
the port, dense vs the paged plain gather path) the bound is the same
5e-5 and bitwise respectively.
"""
import dataclasses
import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfg
from repro.launch.serve import ContinuousBatcher as JaxBatcher
from repro.launch.serve import Request as JaxRequest
from repro.models import CPU_RUNTIME as JAX_RT
from repro.models import forward as jax_forward
from repro.models import layers as jl
from repro.models import model_defs as jax_model_defs
from repro.models.param import materialize as jax_materialize
from repro.serving import engine as jeng
from repro_torch import configs as tcfg
from repro_torch import prng
from repro_torch.convert import from_numpy_tree
from repro_torch.launch import serve as launcher
from repro_torch.models import CPU_RUNTIME, Runtime, forward
from repro_torch.models import layers as tl
from repro_torch.serving import engine as teng
from repro_torch.serving import paged_cache as tpc

ROOT = os.path.join(os.path.dirname(__file__), "..")
REL = 5e-5
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, long_context=False):
    j = dataclasses.replace(jcfg.smoke_variant(jcfg.ARCHS[arch]),
                            compute_dtype="float32")
    t = dataclasses.replace(tcfg.smoke_variant(tcfg.ARCHS[arch]),
                            compute_dtype="float32")
    if long_context:
        j, t = j.for_long_context(), t.for_long_context()
    return j, t


_PARAMS = {}


def _params(arch):
    """The JAX package's smoke params and the same bits in the port
    (a long-context variant has the same tree)."""
    if arch not in _PARAMS:
        jc, _ = _cfgs(arch)
        jp = jax_materialize(jax_model_defs(jc), jax.random.PRNGKey(0))
        _PARAMS[arch] = (jp, from_numpy_tree(jax.tree.map(np.asarray, jp)))
    return _PARAMS[arch]


def _tokens(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _rel_err(ref, got):
    ref = np.asarray(ref, np.float32)
    return np.max(np.abs(ref - got.float().numpy())) / max(1e-30, np.max(np.abs(ref)))


def _jax_cache_flat(jcache):
    return from_numpy_tree(jax.tree.map(np.asarray, jcache))


# ---------------------------------------------------------------------------
# ring_cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [7, 8, 9, 19], ids=["W-1", "W", "W+1", "2W+3"])
def test_ring_cache_bitwise_matches_jax(S):
    W = 8
    rng = np.random.RandomState(S)
    k = rng.randn(2, S, 2, 4).astype(np.float32)
    v = rng.randn(2, S, 2, 4).astype(np.float32)
    ref = jl.ring_cache({"k": jnp.asarray(k), "v": jnp.asarray(v)}, S, W)
    got = tl.ring_cache({"k": torch.from_numpy(k), "v": torch.from_numpy(v)}, S, W)
    assert sorted(got) == sorted(ref)
    for name in ref:
        assert tuple(got[name].shape) == ref[name].shape
        assert str(got[name].dtype)[6:] == str(ref[name].dtype)
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(ref[name]))


def test_ring_cache_keeps_the_last_window_slot_addressed():
    """The reference's own check: S 13, W 8 keeps exactly the last W
    positions, slot-addressed by pos % W."""
    S, W = 13, 8
    k = torch.arange(S, dtype=torch.float32)[None, :, None, None]
    out = tl.ring_cache({"k": k}, S, W)
    sp, kv = out["slot_pos"][0].numpy(), out["k"][0, :, 0, 0].numpy()
    for slot in range(W):
        assert sp[slot] >= S - W and sp[slot] % W == slot
        assert kv[slot] == float(sp[slot])


# ---------------------------------------------------------------------------
# dense decode: against the JAX package and against teacher forcing
# ---------------------------------------------------------------------------

def _decode_both(arch, S, steps, long_context=False, pad=True):
    """Prefill S tokens in both packages (padded by ``steps`` unless
    ``pad`` is off), then ``steps`` decode steps on the same tokens: each
    step's port logits against the JAX package's and against a port
    prefill of the prefix, then the caches leaf for leaf."""
    jc, tc = _cfgs(arch, long_context)
    jp, tp = _params(arch)
    toks = _tokens(tc, 2, S + steps, seed=3)
    _, jcache, _ = jax_forward(jp, jc, JAX_RT, jnp.asarray(toks[:, :S]), mode="prefill")
    _, tcache = forward(tp, tc, CPU_RUNTIME, torch.from_numpy(toks[:, :S]), mode="prefill")
    if pad:
        jcache, tcache = jeng.pad_cache(jcache, steps), teng.pad_cache(tcache, steps)
    jstep = jax.jit(partial(jax_forward, cfg=jc, rt=JAX_RT, mode="decode"))
    for i in range(steps):
        pos = np.full((2,), S + i, np.int32)
        feed = toks[:, S + i:S + i + 1]
        jlog, jcache, _ = jstep(jp, tokens=jnp.asarray(feed), cache=jcache,
                                pos=jnp.asarray(pos))
        tlog, tcache2 = forward(tp, tc, CPU_RUNTIME, torch.from_numpy(feed),
                                mode="decode", cache=tcache, pos=torch.from_numpy(pos))
        assert tcache2 is tcache                     # written in place
        ref, _ = forward(tp, tc, CPU_RUNTIME, torch.from_numpy(toks[:, :S + i + 1]),
                         mode="prefill")
        assert _rel_err(jlog, tlog) <= REL, f"{arch} step {i} vs JAX"
        assert _rel_err(ref.numpy(), tlog) <= REL, f"{arch} step {i} vs teacher forcing"
    jflat = _jax_cache_flat(jcache)
    assert sorted(jflat) == sorted(tcache)
    for name, ref in jflat.items():
        assert tcache[name].shape == ref.shape, name
        if name.endswith("slot_pos"):
            assert torch.equal(tcache[name], ref), name
        else:
            assert _rel_err(ref.numpy(), tcache[name]) <= REL, name


@pytest.mark.parametrize("arch", ["deepseek-7b", "yi-9b", "gemma-2b", "gemma2-27b"])
def test_dense_decode_after_pad_matches_jax_and_teacher_forcing(arch):
    """Prompt 12 (within gemma2-27b's window of 64), 4 steps."""
    _decode_both(arch, S=12, steps=4)


def test_rotated_ring_decode_unpadded_matches_jax_and_teacher_forcing():
    """yi-9b ``for_long_context()`` (every layer windowed, W 64): a prompt
    of 80 rotates every ring at prefill; 6 decode steps on the rings as
    they are, no ``pad_cache``."""
    _, tc = _cfgs("yi-9b", long_context=True)
    assert tc.window == 64
    _decode_both("yi-9b", S=80, steps=6, long_context=True, pad=False)


def test_pad_cache_bitwise_matches_jax_and_raises_on_a_rotated_ring():
    """``pad_cache`` of the JAX package's own prefill cache, carried
    across: bitwise the JAX ``pad_cache`` (zeros, slot_pos -1, local and
    global layers).  On a rotated ring it raises, and so does
    ``greedy_generate`` (the reference asserts there)."""
    jc, tc = _cfgs("gemma2-27b")
    jp, _ = _params("gemma2-27b")
    toks = _tokens(tc, 2, 9, seed=1)
    _, jcache, _ = jax_forward(jp, jc, JAX_RT, jnp.asarray(toks), mode="prefill")
    ref = _jax_cache_flat(jeng.pad_cache(jcache, 5))
    got = teng.pad_cache(_jax_cache_flat(jcache), 5)
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        assert got[name].dtype == r.dtype and torch.equal(got[name], r), name
    # yi-9b for_long_context(): every ring rotated by a prompt of 70 > W 64
    _, tlc = _cfgs("yi-9b", long_context=True)
    _, tp = _params("yi-9b")
    prompt = torch.from_numpy(_tokens(tlc, 1, 70, seed=2))
    _, rotated = forward(tp, tlc, CPU_RUNTIME, prompt, mode="prefill")
    assert int(rotated["blocks.L0.attn.slot_pos"][0, 0, 0]) != 0
    with pytest.raises(ValueError, match="rotated"):
        teng.pad_cache(rotated, 4)
    with pytest.raises(ValueError, match="rotated"):
        teng.greedy_generate(tlc, CPU_RUNTIME, tp, prompt, 3)


# ---------------------------------------------------------------------------
# cache_abstract, cache_batch_axes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma2-27b", "chameleon-34b"])
def test_cache_abstract_matches_jax_leaf_for_leaf(arch):
    jc, tc = jcfg.smoke_variant(jcfg.ARCHS[arch]), tcfg.smoke_variant(tcfg.ARCHS[arch])
    ref = jax.tree_util.tree_flatten_with_path(jeng.cache_abstract(jc, 3, 7))[0]
    ref = {".".join(str(k.key) for k in path): s for path, s in ref}
    got = teng.cache_abstract(tc, 3, 7)
    assert sorted(got) == sorted(ref)
    for name, s in ref.items():
        assert got[name].is_meta, name
        assert tuple(got[name].shape) == s.shape and str(got[name].dtype)[6:] == str(s.dtype)


def test_cache_abstract_allocates_nothing_and_draws_no_weights(monkeypatch):
    """Full-width gemma-2b at 64 x 8192 (a cache of 9.7 GB, weights of
    10 GB): every leaf is a meta tensor, and the random stream is never
    touched."""
    def refuse(*a, **k):
        raise AssertionError("cache_abstract drew from the random stream")
    for name in ("normal", "fold_in", "PRNGKey"):
        monkeypatch.setattr(prng, name, refuse)
    cfg = tcfg.ARCHS["gemma-2b"]
    ab = teng.cache_abstract(cfg, 64, 8192)
    assert all(t.is_meta for t in ab.values())
    assert tuple(ab["blocks.L0.attn.k"].shape) == (18, 64, 8192, 1, 256)
    assert ab["blocks.L0.attn.k"].dtype == torch.bfloat16
    assert tuple(ab["blocks.L0.attn.slot_pos"].shape) == (18, 64, 8192)
    rotated = teng.cache_abstract(cfg.for_long_context(), 2, 8448)
    assert tuple(rotated["blocks.L0.attn.v"].shape) == (18, 2, 8192, 1, 256)


@pytest.mark.parametrize("arch", ["gemma-2b", "gemma2-27b"])
def test_cache_batch_axes_is_one_on_every_leaf(arch):
    tc = tcfg.smoke_variant(tcfg.ARCHS[arch])
    axes = teng.cache_batch_axes(tc)
    ref = jax.tree_util.tree_flatten_with_path(
        jeng.cache_batch_axes(jcfg.smoke_variant(jcfg.ARCHS[arch])))[0]
    assert axes == {".".join(str(k.key) for k in path): a for path, a in ref}
    assert set(axes.values()) == {1}
    ab = teng.cache_abstract(tc, 5, 4)
    assert all(ab[n].shape[a] == 5 for n, a in axes.items())


# ---------------------------------------------------------------------------
# greedy_generate
# ---------------------------------------------------------------------------

def test_greedy_generate_matches_jax_and_manual_argmax():
    jc, tc = _cfgs("deepseek-7b")
    jp, tp = _params("deepseek-7b")
    prompt = _tokens(tc, 2, 12, seed=1)
    ref = np.asarray(jeng.greedy_generate(jc, JAX_RT, jp, jnp.asarray(prompt), max_new=5))
    out = teng.greedy_generate(tc, CPU_RUNTIME, tp, torch.from_numpy(prompt), max_new=5)
    assert out.dtype == torch.int32 and tuple(out.shape) == (2, 5)
    np.testing.assert_array_equal(out.numpy(), ref)
    seq = torch.from_numpy(prompt)
    for i in range(5):
        logits, _ = forward(tp, tc, CPU_RUNTIME, seq, mode="prefill")
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        assert torch.equal(out[:, i], nxt), i
        seq = torch.cat([seq, nxt[:, None]], dim=1)


# ---------------------------------------------------------------------------
# dense vs paged (plain gather path), bitwise at matched geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-7b", "yi-9b", "gemma2-27b"])
def test_dense_decode_bitwise_matches_paged_plain_path(arch):
    """Dense context == the gathered length nbmax * block_size: the
    gathered view is position-ordered like the unrotated dense cache, and
    masked entries weigh exactly 0 after the exp underflows."""
    _, tc = _cfgs(arch)
    _, tp = _params(arch)
    rt = Runtime(device=CPU, paged_kernel=False)
    prefill, step = teng.make_prefill_step(tc, rt), teng.make_serve_step(tc, rt)
    B, S0, max_new, bs = 2, 9, 7, 4
    prompt = torch.from_numpy(_tokens(tc, B, S0, seed=0))
    nbmax = tpc.n_blocks_for(S0 + max_new, bs)
    logits, dense = prefill(tp, prompt)
    paged = tpc.paged_cache_init(tc, B, bs, 32, nbmax, CPU)
    alloc = tpc.BlockAllocator(32, bs)
    for row in range(B):
        ids = [alloc.alloc() for _ in range(nbmax)]
        tpc.set_block_table(paged, row, ids)
        tpc.splice_prefill(paged, dense, row, row, ids)
    dense = teng.pad_cache(dense, nbmax * bs - S0)
    tok_d = tok_p = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    pos = torch.full((B,), S0, dtype=torch.int32)
    for i in range(max_new - 1):
        tok_d, ld, dense = step(tp, dense, tok_d[:, None], pos)
        tok_p, lp, paged = step(tp, paged, tok_p[:, None], pos)
        assert torch.equal(ld, lp), f"{arch} step {i}"
        pos = pos + 1


# ---------------------------------------------------------------------------
# ContinuousBatcher and the launcher
# ---------------------------------------------------------------------------

LENGTHS = (8, 5, 11, 8, 6)


def _drive(batcher, requests):
    """The launcher's dense loop over prepared requests; returns
    {rid: tokens}."""
    queue, done = list(requests), {}
    while queue or any(s is not None for s in batcher.slots):
        for s in batcher.free_slots():
            if queue:
                batcher._admit(queue.pop(0), s)
        if any(s is not None for s in batcher.slots):
            for r in batcher.decode_step():
                done[r.rid] = list(r.out)
    return done


def _prompts(vocab):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in LENGTHS]


@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.7, 0), (0.7, 5)],
                         ids=["greedy", "t0.7", "t0.7-top5"])
def test_continuous_batcher_tokens_equal_jax_batcher(temperature, top_k):
    """Five requests of lengths 5-11 on 2 slots, ctx 16, seed 5: the JAX
    ``ContinuousBatcher`` and the port's draw their keys at the same
    points, so even sampled tokens agree."""
    jc, tc = _cfgs("deepseek-7b")
    jp, tp = _params("deepseek-7b")
    prompts, max_new = _prompts(tc.vocab_size), 5
    kw = dict(temperature=temperature, top_k=top_k, seed=5)
    jb = JaxBatcher(jc, jp, n_slots=2, ctx_len=16, **kw)
    tb = launcher.ContinuousBatcher(tc, tp, 2, 16, rt=CPU_RUNTIME, **kw)
    ref = _drive(jb, [JaxRequest(i, jnp.asarray(p)[None], max_new)
                      for i, p in enumerate(prompts)])
    got = _drive(tb, [launcher.Request(i, torch.from_numpy(p)[None], max_new)
                      for i, p in enumerate(prompts)])
    assert sorted(got) == list(range(len(prompts)))
    assert got == ref
    assert tb.prefill_shapes == jb.prefill_shapes == {(1, n) for n in LENGTHS}
    assert all(len(t) == max_new for t in got.values())
    if temperature == 0.0:        # each request served alone, greedily
        for i, p in enumerate(prompts):
            alone = teng.greedy_generate(tc, CPU_RUNTIME, tp,
                                         torch.from_numpy(p)[None], max_new)
            assert alone[0].tolist() == got[i], i


def test_launcher_engine_dense_returns_the_batchers_tokens(capsys):
    """``--engine dense --reduced --device cpu``: the batcher's tokens on
    the launcher's own weights, and the ``[serve:dense]`` lines."""
    argv = ["--engine", "dense", "--reduced", "--device", "cpu", "--arch",
            "gemma-2b", "--requests", "5", "--slots", "2", "--prompt-len", "6",
            "--max-new", "4", "--temperature", "0.7", "--seed", "3"]
    finished = launcher.main(argv)
    out = capsys.readouterr().out
    assert "[serve:dense] 5 requests, 20 tokens" in out
    assert "[serve:dense] request latency p50" in out
    args = launcher.parse_args(argv)
    cfg = tcfg.smoke_variant(tcfg.ARCHS["gemma-2b"])
    params, _ = launcher.load_model(cfg, CPU_RUNTIME, args.seed)
    rng = np.random.RandomState(args.seed)
    prompts = [rng.randint(0, cfg.vocab_size, (6,)).astype(np.int32)
               for _ in range(5)]
    b = launcher.ContinuousBatcher(cfg, params, 2, 10, rt=CPU_RUNTIME,
                                   temperature=0.7, seed=3)
    want = {r.rid: r.out for r in launcher.serve_dense(b, prompts, 4)}
    assert {r.rid: r.out for r in finished} == want


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["examples/torch_quickstart.py", "--device", "cpu", "--steps", "12"],
    ["examples/torch_serve_lm.py", "--device", "cpu", "--max-new", "6"],
    ["examples/torch_serve_lm.py", "--device", "cpu", "--arch", "yi-9b",
     "--long-context", "--prompt-len", "80", "--max-new", "4"],
], ids=["quickstart", "serve_lm", "serve_lm_long_context"])
def test_example_runs_on_the_cpu(argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable] + argv, cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "generated" in out.stdout or "decoded" in out.stdout
