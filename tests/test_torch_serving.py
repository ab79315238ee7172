"""The PyTorch port's paged serving against the JAX package: the block
allocator, the paged cache, the scheduler's greedy tokens, sampling and
the launcher.

Weights are the JAX package's smoke gemma-2b params carried across by
``repro_torch.convert``, at ``compute_dtype="float32"``, where greedy
tokens of the two schedulers must be equal, and so must tokens sampled
at temperature 0.7 from the same seed."""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfg
from repro.models import CPU_RUNTIME as JAX_RT
from repro.models import model_defs as jax_model_defs
from repro.models.param import materialize as jax_materialize
from repro.serving import paged_cache as jpc
from repro.serving.scheduler import PagedScheduler as JaxScheduler
from repro.serving.scheduler import ServeRequest as JaxRequest
from repro_torch import configs as tcfg
from repro_torch import prng
from repro_torch.convert import from_numpy_tree
from repro_torch.launch import serve as launcher
from repro_torch.models import CPU_RUNTIME
from repro_torch.serving import paged_cache as tpc
from repro_torch.serving.engine import make_serve_step, sample_logits
from repro_torch.serving.paged_cache import (BlockAllocator, PoolExhausted,
                                             n_blocks_for)
from repro_torch.serving.scheduler import PagedScheduler, ServeRequest

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jc = dataclasses.replace(jcfg.smoke_variant(jcfg.ARCHS["gemma-2b"]),
                             compute_dtype="float32")
    tc = dataclasses.replace(tcfg.smoke_variant(tcfg.ARCHS["gemma-2b"]),
                             compute_dtype="float32")
    jp = jax_materialize(jax_model_defs(jc), jax.random.PRNGKey(0))
    return jc, tc, jp, from_numpy_tree(jax.tree.map(np.asarray, jp))


# ---------------------------------------------------------------------------
# BlockAllocator (mirrors tests/test_paged_cache.py)
# ---------------------------------------------------------------------------

def test_n_blocks_for_is_ceil_div():
    assert [n_blocks_for(n, b) for n, b in ((1, 4), (4, 4), (5, 4), (16, 16),
                                           (17, 16))] == [1, 1, 2, 1, 2]


def test_alloc_free_conservation_and_exhaustion():
    a = BlockAllocator(n_blocks=8, block_size=4)
    assert a.n_free == 7                       # block 0 reserved
    ids = [a.alloc() for _ in range(7)]
    assert 0 not in ids and len(set(ids)) == 7
    assert a.n_free == 0 and a.used_blocks == 7
    with pytest.raises(PoolExhausted):
        a.alloc()
    for b in ids:
        a.release(b)
    assert a.n_free == 7 and a.used_blocks == 0
    a.check()


def test_cow_retain_release_refcounts():
    a = BlockAllocator(n_blocks=8, block_size=2)
    b = a.alloc()
    key = a.prefix_key(None, (1, 2))
    a.register(key, b)
    assert a.lookup(key) == b
    a.retain(b)
    assert a.refcount(b) == 2
    a.release(b)                               # one owner remains
    assert a.lookup(key) == b and a.refcount(b) == 1
    a.release(b)                               # last owner: unregistered
    assert a.lookup(key) is None and a.n_free == 7
    a.check()


def test_plan_prompt_shares_longest_prefix_chain():
    a = BlockAllocator(n_blocks=16, block_size=2)
    prompt = [1, 2, 3, 4, 5]                   # blocks (1,2) (3,4) + tail 5
    shared, keys = a.plan_prompt(prompt)
    assert shared == [] and len(keys) == 2
    owned = [a.alloc() for _ in range(3)]
    for k, b in zip(keys, owned):
        a.register(k, b)
    shared2, keys2 = a.plan_prompt(prompt)
    assert shared2 == owned[:2] and keys2 == keys
    assert a.refcount(owned[0]) == 2 and a.refcount(owned[1]) == 2
    shared3, _ = a.plan_prompt([1, 2, 9, 9])
    assert shared3 == owned[:1]
    for b in shared2 + shared3:
        a.release(b)
    a.check()


def test_allocator_traffic_matches_jax_allocator_and_leaks_nothing():
    """Random admit/extend/preempt/finish cycles: the port's allocator
    hands out the same ids as the JAX package's, conserves blocks
    exactly, and ends empty."""
    rng = np.random.RandomState(0)
    a, ja = BlockAllocator(32, 4), jpc.BlockAllocator(32, 4)
    live = {}
    rid = 0
    for _ in range(300):
        op = rng.randint(3)
        if op == 0:
            prompt = rng.randint(0, 50, rng.randint(1, 12)).tolist()
            shared, keys = a.plan_prompt(prompt)
            jshared, _ = ja.plan_prompt(prompt)
            assert shared == jshared
            need = n_blocks_for(len(prompt), 4) - len(shared)
            if a.n_free < need:
                for b in shared:
                    a.release(b)
                    ja.release(b)
                continue
            ids = shared + [a.alloc() for _ in range(need)]
            assert ids[len(shared):] == [ja.alloc() for _ in range(need)]
            for j in range(len(shared), len(keys)):
                a.register(keys[j], ids[j])
                ja.register(keys[j], ids[j])
            live[rid] = ids
            rid += 1
        elif op == 1 and live:
            r = rng.choice(list(live))
            if a.n_free:
                live[r].append(a.alloc())
                assert live[r][-1] == ja.alloc()
        elif op == 2 and live:
            r = rng.choice(list(live))
            for b in live.pop(r):
                a.release(b)
                ja.release(b)
        a.check()
        assert a.used_blocks + a.n_free == a.n_blocks - 1
    for ids in live.values():
        for b in ids:
            a.release(b)
    a.check()
    assert a.used_blocks == 0


def test_paged_cache_layout_matches_jax(model):
    jc, tc, _, _ = model
    jp = jpc.paged_cache_init(jc, 3, 4, 10, 5)
    tp = tpc.paged_cache_init(tc, 3, 4, 10, 5, torch.device("cpu"))
    for leaf in ("kp", "vp", "bt"):
        ref = jp["blocks"]["L0"]["attn"][leaf]
        got = tp[f"blocks.L0.attn.{leaf}"]
        assert tuple(got.shape) == ref.shape and str(got.dtype)[6:] == str(ref.dtype)
    assert tpc.paged_kv_bytes_per_block(tp) == jpc.paged_kv_bytes_per_block(jp)
    jp = jpc.set_block_table(jp, 1, [3, 7])
    tpc.set_block_table(tp, 1, [3, 7])
    np.testing.assert_array_equal(np.asarray(jp["blocks"]["L0"]["attn"]["bt"]),
                                  tp["blocks.L0.attn.bt"].numpy())


# ---------------------------------------------------------------------------
# scheduler: greedy tokens equal to the JAX scheduler's
# ---------------------------------------------------------------------------

def _traffic(case, vocab):
    """(prompts, scheduler kwargs, max_new per request)."""
    rng = np.random.RandomState(0)
    if case == "shared_prefix":
        # request 0 runs long; 1 and 2 finish after one chunk, and the
        # duplicate of 0 and a prompt sharing its two-block prefix are
        # then admitted while 0 still holds its blocks (COW)
        prefix = rng.randint(0, vocab, (8,)).astype(np.int32)
        first = np.concatenate([prefix, [5, 6, 7]]).astype(np.int32)
        prompts = [first,
                   rng.randint(0, vocab, (6,)).astype(np.int32),
                   rng.randint(0, vocab, (9,)).astype(np.int32),
                   first.copy(),
                   np.concatenate([prefix, [9]]).astype(np.int32),
                   rng.randint(0, vocab, (13,)).astype(np.int32)]
        return prompts, dict(n_slots=3, block_size=4, n_blocks=64, ctx_max=32,
                             decode_chunk=3, buckets=[8, 16, 32]), [9, 2, 2, 5, 4, 3]
    # 4 requests need 8 blocks each at full length; the pool holds 20
    prompts = [rng.randint(0, vocab, (8,)).astype(np.int32) for _ in range(4)]
    return prompts, dict(n_slots=4, block_size=4, n_blocks=21, ctx_max=32,
                         decode_chunk=4), [24] * 4


@pytest.mark.parametrize("case", ["shared_prefix", "preemption"])
def test_scheduler_greedy_tokens_equal_jax_scheduler(model, case):
    jc, tc, jp, tp = model
    prompts, kw, max_new = _traffic(case, tc.vocab_size)
    outs, stats = [], []
    for Sched, Req, cfg, params, rt in (
            (JaxScheduler, JaxRequest, jc, jp, JAX_RT),
            (PagedScheduler, ServeRequest, tc, tp, CPU_RUNTIME)):
        s = Sched(cfg, params, rt, **kw)
        for i, p in enumerate(prompts):
            s.submit(Req(rid=i, prompt=p.copy(), max_new=max_new[i]))
        outs.append({r.rid: list(r.out) for r in s.run()})
        s.alloc.check()
        assert s.alloc.used_blocks == 0                  # no leaked blocks
        stats.append(s.stats)
    assert sorted(outs[1]) == list(range(len(prompts)))
    assert outs[1] == outs[0]
    for key in ("peak_used_blocks", "preemptions", "decode_steps",
                "prefill_calls"):
        assert stats[1][key] == stats[0][key], key
    if case == "preemption":
        assert stats[1]["preemptions"] > 0
    else:
        assert stats[1]["cow_shared_blocks"] == 4


@pytest.mark.parametrize("case,top_k", [("shared_prefix", 0), ("preemption", 20)])
def test_scheduler_sampled_tokens_equal_jax_scheduler(model, case, top_k):
    """At temperature 0.7 both schedulers fold the same counter into
    PRNGKey(seed) at the same points and draw the same Gumbel noise."""
    jc, tc, jp, tp = model
    prompts, kw, max_new = _traffic(case, tc.vocab_size)
    kw = dict(kw, temperature=0.7, top_k=top_k, seed=5)
    outs = []
    for Sched, Req, cfg, params, rt in (
            (JaxScheduler, JaxRequest, jc, jp, JAX_RT),
            (PagedScheduler, ServeRequest, tc, tp, CPU_RUNTIME)):
        s = Sched(cfg, params, rt, **kw)
        for i, p in enumerate(prompts):
            s.submit(Req(rid=i, prompt=p.copy(), max_new=max_new[i]))
        outs.append({r.rid: list(r.out) for r in s.run()})
    greedy = PagedScheduler(tc, tp, CPU_RUNTIME, **dict(kw, temperature=0.0))
    for i, p in enumerate(prompts):
        greedy.submit(ServeRequest(rid=i, prompt=p.copy(), max_new=max_new[i]))
    assert sorted(outs[1]) == list(range(len(prompts)))
    assert outs[1] == outs[0]
    assert outs[1] != {r.rid: list(r.out) for r in greedy.run()}


def test_scheduler_sampling_is_deterministic_under_seed(model):
    _, tc, _, tp = model
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, tc.vocab_size, (6,)).astype(np.int32)
               for _ in range(4)]

    def run(seed):
        s = PagedScheduler(tc, tp, CPU_RUNTIME, n_slots=2, block_size=4,
                           n_blocks=32, ctx_max=16, decode_chunk=2,
                           temperature=0.8, top_k=20, seed=seed)
        for i, p in enumerate(prompts):
            s.submit(ServeRequest(rid=i, prompt=p, max_new=6))
        return {r.rid: list(r.out) for r in s.run()}

    assert run(7) == run(7)
    assert run(7) != run(8)


def test_sample_logits_top_k_membership_and_determinism():
    logits = torch.from_numpy(np.random.RandomState(0).randn(4, 64).astype(np.float32) * 3)
    topk = torch.topk(logits, 5).indices
    key = prng.PRNGKey(0)
    for i in range(8):
        s = sample_logits(logits, prng.fold_in(key, i), temperature=0.9, top_k=5)
        assert s.dtype == torch.int32
        assert all(int(s[b]) in topk[b].tolist() for b in range(4))
    a = sample_logits(logits, prng.PRNGKey(1), 0.7, 10)
    b = sample_logits(logits, prng.PRNGKey(1), 0.7, 10)
    assert torch.equal(a, b)


def test_serve_step_temperature_zero_is_greedy(model):
    _, tc, _, tp = model
    paged = tpc.paged_cache_init(tc, 2, 4, 8, 2, torch.device("cpu"))
    tpc.set_block_table(paged, 0, [1, 2])
    tpc.set_block_table(paged, 1, [3, 4])
    tok = torch.tensor([[3], [5]], dtype=torch.int32)
    pos = torch.tensor([0, 0], dtype=torch.int32)
    greedy = make_serve_step(tc, CPU_RUNTIME)
    tempered = make_serve_step(tc, CPU_RUNTIME, temperature=0.0, top_k=5)
    t1, l1, _ = greedy(tp, paged, tok, pos)
    t2, l2, _ = tempered(tp, paged, tok, pos, prng.PRNGKey(9))
    assert torch.equal(t1, t2) and torch.equal(l1, l2)
    assert torch.equal(t1, torch.argmax(l1, dim=-1).to(torch.int32))


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

def test_launcher_reduced_on_cpu_runs():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--arch", "gemma-2b", "--requests", "5",
         "--blocks", "10", "--max-new", "20"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert "[serve:paged] 5 requests, 100 tokens" in out.stdout
    assert any(l.startswith("[serve:paged] request latency p50") for l in lines)
    assert any(l.startswith("[serve:paged] peak blocks") and "preemptions" in l
               for l in lines)


def test_launcher_raises_without_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--reduced", "--arch", "gemma-2b"])
