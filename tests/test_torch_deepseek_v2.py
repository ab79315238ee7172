"""The DeepSeek-V2 family in the port (MLA attention, capacity-dispatched
MoE, a dense prefix layer) against the JAX package: parameter trees,
``forward`` in its three modes, the loss with its MoE aux loss and
every gradient, SNGM on the engine, the paged scheduler and the
``ContinuousBatcher``, and both launchers.

Models: the smoke variants of deepseek-v2-lite-16b and deepseek-v2-236b
(2 layers, no prefix; 236b compresses the query), and a 3-layer lite
variant whose first layer is a dense prefix layer (the smoke variant
has none).  Weights are the JAX package's ``materialize(model_defs(cfg),
PRNGKey(0))`` carried across by ``repro_torch.convert``, except where
said; tokens come from numpy with a seed.  Bounds, and why:

  * forward logits (and train-mode hidden states, prefill caches):
    fp32 5e-5 and bf16 5e-2 of the largest magnitude, the model tests'
    bounds; the aux loss 1e-6 relative (fp32; 1e-2 in bf16, where the
    router's input differs by bf16 roundings).  The 3-layer variant's
    bf16 case runs on weights redrawn at their true fan-in (below): at
    the reference init, scaling one prefix leaf by one bf16 step moves
    the JAX package's own bf16 logits by more than the bf16 bound
    (``test_reference_init_of_the_prefix_variant_is_ill_conditioned_in_bf16``),
    so bf16 there can only be held on better-conditioned weights;
  * ``loss_fn`` and every gradient: 2e-5 of each JAX gradient's largest
    magnitude, the loss 2e-5 and ``aux_loss`` 1e-6 relative (fp32), on
    weights redrawn at their true fan-in, as ``tests/test_torch_train.py``
    does (the reference init reads a stacked leaf's fan-in from the
    layer axis); with remat the gradients are bitwise those without;
  * SNGM on the engine (``fused="multi_tensor"``) against
    ``fused=None``: bitwise, 3 steps, 2 launches a step;
  * the paged scheduler's and the ``ContinuousBatcher``'s tokens at
    temperature 0 and 0.7: equal to the JAX ones (fp32 compute; the
    scheduler pads prompts to a bucket and to ``n_slots`` rows, and the
    padding takes MoE capacity in both packages alike).
"""
import contextlib
import dataclasses
import json
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
from repro.models import model_defs as jax_model_defs
from repro.models import moe as jmoe
from repro.models.param import count as jax_count
from repro.models.param import is_def, materialize as jax_materialize
from repro.serving import engine as jeng
from repro.serving.scheduler import PagedScheduler as JaxScheduler
from repro.serving.scheduler import ServeRequest as JaxServeRequest
from repro.training import step as jstep
from repro_torch import configs as tcfg
from repro_torch import kernels
from repro_torch.convert import from_numpy_tree
from repro_torch.core import optim as topt
from repro_torch.core import schedules as tsched
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import (CPU_RUNTIME, Runtime, cast_for_compute, count,
                                forward, materialize, model_defs)
from repro_torch.models import moe as tmoe
from repro_torch.models.param import flatten_defs
from repro_torch import prng
from repro_torch.serving import engine as teng
from repro_torch.serving.scheduler import PagedScheduler, ServeRequest
from repro_torch.training import step as tstep

CPU = torch.device("cpu")
REL = {"float32": 5e-5, "bfloat16": 5e-2}
AUX_REL = {"float32": 1e-6, "bfloat16": 1e-2}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(variant, dtype="float32"):
    arch = "deepseek-v2-236b" if variant == "236b" else "deepseek-v2-lite-16b"
    out = []
    for mod in (jcfg, tcfg):
        c = dataclasses.replace(mod.smoke_variant(mod.ARCHS[arch]),
                                compute_dtype=dtype)
        if variant == "lite-prefix":
            c = dataclasses.replace(c, n_layers=3, moe=dataclasses.replace(
                c.moe, n_dense_prefix=1))
        out.append(c)
    return out


# contracted dims of each matmul leaf, from its shape without a layer axis
FAN_IN = {"wq": lambda s: s[0], "wkv_a": lambda s: s[0], "wq_a": lambda s: s[0],
          "wk_b": lambda s: s[0], "wv_b": lambda s: s[0], "wq_b": lambda s: s[0],
          "wo": lambda s: s[0] * s[1], "wg": lambda s: s[-2],
          "wu": lambda s: s[-2], "wd": lambda s: s[-2], "unembed": lambda s: s[0]}

_PARAMS = {}


def _params(variant, redraw=False):
    """The JAX package's params as a numpy tree; with ``redraw`` every
    matmul weight redrawn from numpy at 1/sqrt(its true fan-in) (the
    router keeps its 0.02, norms and the embedding their values)."""
    key = (variant, redraw)
    if key not in _PARAMS:
        jc, _ = _cfgs(variant)
        tree = jax.tree.map(np.asarray, jax_materialize(jax_model_defs(jc),
                                                        jax.random.PRNGKey(0)))
        if redraw:
            r = np.random.RandomState(0)

            def walk(node, name=None, stacked=False):
                if isinstance(node, dict):
                    return {k: walk(v, k, stacked or k == "blocks")
                            for k, v in node.items()}
                if name not in FAN_IN:
                    return node
                s = node.shape[1:] if stacked else node.shape
                return np.asarray(r.randn(*node.shape) / np.sqrt(FAN_IN[name](s)),
                                  np.float32)
            tree = walk(tree)
        _PARAMS[key] = tree
    return _PARAMS[key]


def _tokens(vocab, B, S, seed):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(np.int32)


def _rel(ref, got):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
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
# parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-v2-236b"])
def test_full_width_defs_and_counts_match_jax(arch):
    """deepseek-v2-lite-16b: 15,706,484,224 params; one prefix layer
    without a stacked dim, 26 stacked MoE layers."""
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
    if arch == "deepseek-v2-lite-16b":
        # the analytic ``param_count`` (15,706,525,696) counts 3 x d_model
        # of norms an attention layer where the tree holds 2 x d_model + r
        assert count(td) == 15_706_484_224
        assert tflat["blocks.L0.moe.wg"].shape == (26, 64, 2048, 1408)
        assert tflat["prefix.P0.ffn.wg"].shape == (2048, 10944)


def test_load_model_casts_each_leaf_as_cast_for_compute_does():
    """The serving launcher casts each matmul leaf as it is drawn; the
    bits are those of ``cast_for_compute`` on the fp32 tree; the router
    and the norm scales stay fp32."""
    _, tc = _cfgs("lite-prefix", "bfloat16")
    got, n = serve_launcher.load_model(tc, CPU_RUNTIME, seed=0)
    want = cast_for_compute(materialize(model_defs(tc), prng.PRNGKey(0), CPU), tc)
    assert n == count(model_defs(tc)) and sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert got["blocks.L0.moe.router"].dtype == torch.float32
    assert got["blocks.L0.attn.kv_norm"].dtype == torch.float32
    for leaf in ("attn.wkv_a", "attn.wk_b", "attn.wv_b", "attn.wq", "moe.wg",
                 "moe.shared.wd"):
        assert got["blocks.L0." + leaf].dtype == torch.bfloat16, leaf


# ---------------------------------------------------------------------------
# forward, three modes
# ---------------------------------------------------------------------------

FWD = [("lite", "float32"), ("236b", "float32"), ("lite-prefix", "float32"),
       ("lite", "bfloat16"), ("lite-prefix", "bfloat16")]


@contextlib.contextmanager
def _routes(monkeypatch):
    """Record the expert ids every MoE layer picks, in both packages:
    {"jax": [...], "port": [...]} of (T, k) arrays, and the port's
    router probabilities.  The JAX side reports through an ordered
    ``jax.debug.callback``, so it stays jitted."""
    rec = {"jax": [], "port": [], "probs": []}
    j_route, t_route = jmoe.route, tmoe.route

    def jax_route(logits, cfg):
        out = j_route(logits, cfg)
        jax.debug.callback(lambda ids: rec["jax"].append(np.asarray(ids)),
                           out[1], ordered=True)
        return out

    def port_route(logits, cfg):
        out = t_route(logits, cfg)
        rec["port"].append(out[1].numpy())
        rec["probs"].append(torch.softmax(logits.float(), -1).numpy())
        return out
    monkeypatch.setattr(jmoe, "route", jax_route)
    monkeypatch.setattr(tmoe, "route", port_route)
    yield rec
    jax.effects_barrier()


def _held(rec, B, S, k):
    """(B, S) mask of the positions whose rows routed every token up to
    them alike in both packages.  A token routed otherwise must be a near
    tie: its k-th and (k+1)-th router probabilities (the port's) within
    2e-3 of each other, which bf16 roundings upstream can swap."""
    jax.effects_barrier()
    assert len(rec["jax"]) == len(rec["port"]) > 0
    flip = np.zeros((B, S), bool)
    for jids, tids, probs in zip(rec["jax"], rec["port"], rec["probs"]):
        f = (np.sort(jids, -1) != np.sort(tids, -1)).any(-1).reshape(B, S)
        top = -np.sort(-probs, -1)
        gap = (top[:, k - 1] - top[:, k]).reshape(B, S)
        assert (gap[f] < 2e-3).all(), gap[f]
        flip |= f
    rec["jax"].clear(), rec["port"].clear(), rec["probs"].clear()
    return ~np.cumsum(flip, axis=1).astype(bool)


@pytest.mark.parametrize("variant,dtype", FWD, ids=[f"{v}-{d}" for v, d in FWD])
def test_forward_three_modes_match_jax(variant, dtype, monkeypatch):
    """Train mode (hidden states, aux), prefill (last-position logits,
    the latent caches), one dense decode step (logits; in fp32 the decode
    steps of ``tests/test_torch_mla.py`` hold it).  In bf16 a token
    whose routing differs between the packages (a near tie, ``_held``)
    and the rest of its row are left out of the bound, and at most 2 of
    the 24 tokens may differ."""
    jc, tc = _cfgs(variant, dtype)
    npp = _params(variant, redraw=(variant == "lite-prefix" and dtype == "bfloat16"))
    jp, tp = jax.tree.map(jnp.asarray, npp), from_numpy_tree(npp)
    B, S = 2, 12
    toks = _tokens(tc.vocab_size, B, S + 1, 5)
    rel = REL[dtype]
    jfwd = jax.jit(partial(jax_forward, cfg=jc, rt=JAX_RT),
                   static_argnames=("mode",))
    with (_routes(monkeypatch) if dtype == "bfloat16"
          else contextlib.nullcontext()) as rec:
        jh, _, jaux = jfwd(jp, tokens=jnp.asarray(toks[:, :S]), mode="train")
        th, taux = forward(tp, tc, CPU_RUNTIME, torch.from_numpy(toks[:, :S]), mode="train")
        held = np.ones((B, S), bool) if rec is None else _held(rec, B, S, tc.moe.top_k)
        assert held.sum() >= B * S - 2 and held[:, :S - 1].any(-1).all()
        assert _rel(np.asarray(jh, np.float32)[held], th.float()[torch.from_numpy(held)]) <= rel
        assert taux.dtype == torch.float32 and taux.dim() == 0
        assert abs(float(taux) - float(jaux)) <= AUX_REL[dtype] * abs(float(jaux))
        jl, jcache, _ = jfwd(jp, tokens=jnp.asarray(toks[:, :S]), mode="prefill")
        tl, tcache = forward(tp, tc, CPU_RUNTIME, torch.from_numpy(toks[:, :S]), mode="prefill")
        if rec is not None:
            assert (_held(rec, B, S, tc.moe.top_k) == held).all()
        rows = held[:, -1]
        assert _rel(np.asarray(jl)[rows], tl[torch.from_numpy(rows)]) <= rel
        jflat = _flat(jcache)
        assert sorted(jflat) == sorted(tcache)
        for name, ref in jflat.items():
            assert tuple(tcache[name].shape) == ref.shape, name
            if name.endswith("slot_pos"):
                assert np.array_equal(ref, tcache[name].numpy()), name
            else:
                assert _rel(ref[..., rows, :, :] if ref.ndim == 4 else ref[rows],
                            tcache[name][..., torch.from_numpy(rows), :, :]
                            if ref.ndim == 4 else tcache[name][torch.from_numpy(rows)]
                            ) <= rel, name
        if dtype == "float32":
            return
        jcache, tcache = jeng.pad_cache(jcache, 1), teng.pad_cache(tcache, 1)
        pos = np.full((B,), S, np.int32)
        jd, _, _ = jfwd(jp, tokens=jnp.asarray(toks[:, S:]), mode="decode",
                        cache=jcache, pos=jnp.asarray(pos))
        td, _ = forward(tp, tc, CPU_RUNTIME, torch.from_numpy(toks[:, S:]), mode="decode",
                        cache=tcache, pos=torch.from_numpy(pos))
        if rec is not None:
            rows = rows & _held(rec, B, 1, tc.moe.top_k)[:, 0]
        assert rows.any()
        assert _rel(np.asarray(jd)[rows], td[torch.from_numpy(rows)]) <= rel


def test_reference_init_of_the_prefix_variant_is_ill_conditioned_in_bf16():
    """Why the 3-layer variant's bf16 cases run on redrawn weights: at the
    reference init, scaling one prefix leaf by one bf16 step (1 + 2^-7)
    moves the JAX package's own bf16 prefill logits by more than the bf16
    bound (0.074 of their max on this input); on the redrawn weights the
    same step moves them less (0.013)."""
    jc, _ = _cfgs("lite-prefix", "bfloat16")
    jfwd = jax.jit(partial(jax_forward, cfg=jc, rt=JAX_RT, mode="prefill"))
    toks = jnp.asarray(_tokens(jc.vocab_size, 2, 12, 0))
    moved = {}
    for redraw in (False, True):
        npp = _params("lite-prefix", redraw=redraw)
        nudged = jax.tree.map(lambda a: a, npp)
        nudged["prefix"]["P0"]["ffn"]["wd"] = (npp["prefix"]["P0"]["ffn"]["wd"]
                                               * np.float32(1 + 2**-7))
        ref = np.asarray(jfwd(jax.tree.map(jnp.asarray, npp), tokens=toks)[0],
                         np.float32)
        moved[redraw] = _rel(ref, jfwd(jax.tree.map(jnp.asarray, nudged),
                                       tokens=toks)[0])
    assert moved[False] > REL["bfloat16"] > moved[True], moved


@pytest.mark.parametrize("variant", ["lite-prefix"])
def test_cache_abstract_and_batch_axes_match_jax(variant):
    jc, tc = _cfgs(variant)
    want = _flat(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                              jeng.cache_abstract(jc, 2, 5)))
    got = teng.cache_abstract(tc, 2, 5)
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        assert tuple(got[k].shape) == a.shape and got[k].device.type == "meta", k
    axes = teng.cache_batch_axes(tc)
    assert axes == {k: int(v) for k, v in _flat(jeng.cache_batch_axes(jc)).items()}
    assert axes["prefix.P0.attn.ckv"] == 0 and axes["blocks.L0.attn.ckv"] == 1


# ---------------------------------------------------------------------------
# the loss, its aux term and every gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["lite-prefix", "236b"])
def test_loss_aux_and_every_gradient_match_jax(variant):
    jc, tc = _cfgs(variant)
    npp = _params(variant, redraw=True)
    r = np.random.RandomState(1)
    tokens = r.randint(0, tc.vocab_size, (2, 16)).astype(np.int32)
    mask = (r.rand(2, 16) > 0.2).astype(np.float32)
    batch = {"tokens": tokens, "loss_mask": mask}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
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
    aux = float(tm["aux_loss"].detach())
    assert abs(aux - float(jm["aux_loss"])) <= 1e-6 * abs(float(jm["aux_loss"]))
    assert aux > 0
    assert float(tl.detach()) == float((tm["ce_loss"] + tm["aux_loss"]).detach())
    want = from_numpy_tree(jax.tree.map(np.asarray, jg))
    assert set(want) == set(grads[True])
    for k, g in want.items():
        assert _rel(g, grads[False][k]) <= 2e-5, k
        assert torch.equal(grads[True][k], grads[False][k]), k
    assert float(grads[False]["blocks.L0.moe.router"].abs().max()) > 0


def test_sngm_engine_bitwise_fused_none_with_two_launches_a_step():
    """3 SNGM steps (n_micro 2, bf16 compute) of the 3-layer variant on
    the engine and on ``fused=None``: params, momentum and stats bitwise;
    1 chunk_sumsq + 1 fused_update a step; aux_loss a finite stat."""
    _, tc = _cfgs("lite-prefix", "bfloat16")
    npp = _params("lite-prefix")
    r = np.random.RandomState(2)
    batches = [{"tokens": torch.from_numpy(r.randint(0, tc.vocab_size, (4, 16))
                                          .astype(np.int32)),
                "loss_mask": torch.ones((4, 16))} for _ in range(3)]
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
    assert sta == stb
    assert all(np.isfinite(s["aux_loss"]) and s["aux_loss"] > 0 for s in stb)
    assert all(l["chunk_sumsq"] == 1 and l["fused_update"] == 1
               and sum(l.values()) == 2 for l in lb)
    pa, pb = sa.params_view, sb.params_view
    assert sorted(pa) == sorted(pb)
    for k in pa:
        assert torch.equal(pa[k].view(torch.int32), pb[k].view(torch.int32)), k
    ma, mb = topt.to_pytree(sa.opt_state), topt.to_pytree(sb.opt_state)
    for k, v in ma.momentum.items():
        assert torch.equal(v.view(torch.int32), mb.momentum[k].view(torch.int32)), k


# ---------------------------------------------------------------------------
# serving: the paged scheduler and the ContinuousBatcher against JAX
# ---------------------------------------------------------------------------

LENGTHS = (8, 5, 11, 8, 5)


def _prompts(vocab):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in LENGTHS]


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_paged_scheduler_tokens_equal_jax_scheduler(temperature):
    """Five requests on 3 slots, block size 4, buckets 8 and 16, chunks
    of 3, a pool that preempts: the same tokens and counters."""
    jc, tc = _cfgs("lite")
    npp = _params("lite")
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
    for key in ("peak_used_blocks", "preemptions", "decode_steps", "prefill_calls"):
        assert stats[1][key] == stats[0][key], key
    assert stats[1]["preemptions"] > 0


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_continuous_batcher_tokens_equal_jax_batcher(temperature):
    jc, tc = _cfgs("lite")
    npp = _params("lite")
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


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_train_launcher_runs_deepseek_with_aux_loss_in_its_records(capsys, tmp_path):
    lines = {}
    for fused in ("none", "multi_tensor"):
        path = tmp_path / f"{fused}.jsonl"
        losses = train_launcher.main(
            ["--arch", "deepseek-v2-lite-16b", "--reduced", "--device", "cpu",
             "--steps", "2", "--batch", "4", "--seq", "16", "--log-every", "1",
             "--fused", fused, "--metrics-jsonl", str(path)])
        out = capsys.readouterr().out.splitlines()
        assert out[0].startswith("[train] deepseek-v2-lite-16b-smoke: ")
        lines[fused] = [l.split(" (")[0] for l in out if l.startswith("  step")]
        assert len(losses) == 2 and all(np.isfinite(losses))
        recs = [json.loads(l) for l in path.read_text().splitlines()]
        aux = [r["aux_loss"] for r in recs if "aux_loss" in r]
        assert len(aux) == 2 and all(np.isfinite(a) and a > 0 for a in aux)
    assert len(lines["none"]) == 2 and lines["none"] == lines["multi_tensor"]


@pytest.mark.parametrize("engine", ["paged", "dense"])
def test_serve_launcher_runs_deepseek_on_both_engines(engine, capsys):
    argv = ["--arch", "deepseek-v2-lite-16b", "--reduced", "--device", "cpu",
            "--engine", engine, "--requests", "3", "--slots", "2",
            "--prompt-len", "6", "--max-new", "4"]
    finished = serve_launcher.main(argv)
    out = capsys.readouterr().out
    assert f"[serve:{engine}] 3 requests, 12 tokens" in out
    assert sorted(r.rid for r in finished) == [0, 1, 2]
    vocab = tcfg.smoke_variant(tcfg.ARCHS["deepseek-v2-lite-16b"]).vocab_size
    assert all(len(r.out) == 4 and all(0 <= t < vocab for t in r.out)
               for r in finished)
