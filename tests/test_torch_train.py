"""The port's training path against the JAX package: schedules, data,
loss, gradients, the train step and the launcher.

Weights have the JAX package's tree, dtypes and norm/embedding values
(``materialize(model_defs(cfg), PRNGKey(0))``), with every matmul weight
redrawn from numpy at 1/sqrt(its true fan-in), and cross with
``repro_torch.convert``; tokens come from numpy with a seed, or from the
JAX package's ``SyntheticLM``.  The redraw is for conditioning: the
reference init reads the fan-in of a stacked leaf from its layer axis
(2 on the smoke models), so activations grow to tens inside the stack,
and moving those weights by one fp32 ulp moves the JAX package's own
gradients by 8e-4 (gemma-2b) and 5e-3 (deepseek-7b); with the redrawn
weights the same perturbation moves them by 2e-6.  Bounds, and why:

  * schedules: within 4 ulp of the JAX package's (``pow`` and ``cos``
    round differently in XLA and in PyTorch by an ulp, and ``lr0 *``
    can add one); ``constant`` and ``step_decay`` bitwise;
  * ``lm_loss`` value and gradients: 1e-5 relative (fp32; the logits
    matmul sums in another order); with ``logits_bf16`` each gradient
    within one bf16 step of the value (2^-7 max(|x|, |y|)) plus 1e-5 of
    its largest magnitude: both packages multiply the unrounded fp32
    cotangent by the other bf16 operand and round the fp32 sum to bf16
    (``layers.bf16_dot``), and a sum near a rounding edge can land on
    either side (0 beyond the step measured; 1.7e-3 of the max as a
    plain relative difference);
  * ``loss_fn`` value and every gradient, relative to the largest
    magnitude of each JAX gradient: 2e-5 at ``compute_dtype="float32"``
    (2e-6 measured, the size of the JAX package's own one-ulp
    sensitivity), 5e-2 at bf16 compute (bf16 rounds at other places in
    the two frameworks; 2e-2 measured, 1e-2 for JAX against itself);
  * a 4-step SNGM trajectory with n_micro = 2 at fp32 compute: loss,
    grad_norm and lr within 1e-5 relative at every step;
  * the port's ``--fused none`` and ``--fused multi_tensor``: bitwise.
"""
import dataclasses
import os
import re
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jcfg
from repro.core import optim as jopt
from repro.core import schedules as jsched
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.models import CPU_RUNTIME as JAX_RT
from repro.models import model_defs as jax_model_defs
from repro.models.param import materialize as jax_materialize
from repro.training import loss as jloss
from repro.training import step as jstep
from repro_torch import configs as tcfg
from repro_torch.convert import (from_numpy_tree, tensor_to_array,
                                 train_state_from_numpy, train_state_to_numpy)
from repro_torch.core import multi_tensor as tmt
from repro_torch.core import optim as topt
from repro_torch.core import schedules as tsched
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as launcher
from repro_torch.models import Runtime
from repro_torch.tracker import (CompositeTracker, JsonlTracker, MemoryTracker,
                                 read_jsonl, scalarize)
from repro_torch.tracker.callbacks import CallbackRunner, StepTimer
from repro_torch.training import loss as tloss
from repro_torch.training import step as tstep

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
GRAD_REL = {"float32": 2e-5, "bfloat16": 5e-2}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(ref, got):
    ref = np.asarray(ref, np.float32)
    got = (tensor_to_array(got) if isinstance(got, torch.Tensor)
           else np.asarray(got)).astype(np.float32)
    return float(np.abs(ref - got).max()) / max(float(np.abs(ref).max()), 1e-30)


def _cfgs(arch, dtype):
    j = dataclasses.replace(jcfg.smoke_variant(jcfg.ARCHS[arch]), compute_dtype=dtype)
    t = dataclasses.replace(tcfg.smoke_variant(tcfg.ARCHS[arch]), compute_dtype=dtype)
    return j, t


_PARAMS = {}
# contracted dims of each stacked matmul leaf (layer axis first)
FAN_IN = {"wq": lambda s: s[1], "wk": lambda s: s[1], "wv": lambda s: s[1],
          "wo": lambda s: s[1] * s[2], "wg": lambda s: s[1],
          "wu": lambda s: s[1], "wd": lambda s: s[1], "unembed": lambda s: s[0]}


def _params(arch):
    """The JAX package's smoke params, matmul weights redrawn at their
    true fan-in (module docstring), as a numpy tree."""
    if arch not in _PARAMS:
        jc, _ = _cfgs(arch, "float32")
        jp = jax_materialize(jax_model_defs(jc), jax.random.PRNGKey(0))
        r = np.random.RandomState(0)

        def redraw(node, name=None):
            if isinstance(node, dict):
                return {k: redraw(v, k) for k, v in node.items()}
            a = np.asarray(node)
            if name in FAN_IN:
                a = np.asarray(r.randn(*a.shape) / np.sqrt(FAN_IN[name](a.shape)),
                               np.float32)
            return a
        _PARAMS[arch] = redraw(jp)
    return _PARAMS[arch]


def _batch(vocab, B=2, S=32, seed=0):
    r = np.random.RandomState(seed)
    tokens = r.randint(0, vocab, (B, S)).astype(np.int32)
    mask = (r.rand(B, S) > 0.2).astype(np.float32)
    return tokens, mask


# ---------------------------------------------------------------------------
# schedules, data
# ---------------------------------------------------------------------------

SCHEDULES = [
    {"name": "constant", "kwargs": {"lr": 0.1}},
    {"name": "poly_power", "kwargs": {"lr0": 1.6, "total_steps": 50, "power": 1.1}},
    {"name": "step_decay", "kwargs": {"lr0": 0.1, "milestones": [3, 7]}},
    {"name": "cosine", "kwargs": {"lr0": 0.3, "total_steps": 20, "final_frac": 0.1}},
    {"name": "warmup", "kwargs": {"base": {"name": "poly_power", "kwargs": {
        "lr0": 1.6, "total_steps": 50}}, "warmup_steps": 5, "init_lr": 0.01}},
]


@pytest.mark.parametrize("spec", SCHEDULES, ids=[s["name"] for s in SCHEDULES])
def test_schedules_match_jax(spec):
    j, t = jsched.make_schedule(spec), tsched.make_schedule(spec)
    want = np.array([j(jnp.asarray(i, jnp.int32)) for i in range(60)], np.float32)
    got = np.array([t(i).item() for i in range(60)], np.float32)
    assert all(t(i).dtype == torch.float32 for i in (0, 7))
    ulp = np.abs(want.view(np.int32).astype(np.int64) - got.view(np.int32))
    assert ulp.max() <= (0 if spec["name"] in ("constant", "step_decay") else 4)
    assert torch.equal(t(torch.tensor(7, dtype=torch.int32)), t(7))


def test_synthetic_table_and_walk_match_jax():
    j = JaxSyntheticLM(1024, 32, 4, seed=3, branching=4)
    t = SyntheticLM(1024, 32, 4, seed=3, branching=4)
    assert np.array_equal(np.asarray(j.table), t.table)
    for i in (0, 5):
        key = jax.random.fold_in(jax.random.PRNGKey(3), i)
        k0, k1 = jax.random.split(key)
        tok0 = jax.random.randint(k0, (4,), 0, 1024, jnp.int32)
        choices = jax.random.randint(k1, (4, 32), 0, 4, jnp.int32)
        assert np.array_equal(np.asarray(j.batch_at(i)["tokens"]),
                              t.walk(np.asarray(tok0), np.asarray(choices)))
    a, b = t.batch_at(2), t.batch_at(2)
    assert torch.equal(a["tokens"], b["tokens"]) and a["tokens"].shape == (4, 32)
    assert not torch.equal(a["tokens"], t.batch_at(3)["tokens"])
    nxt = torch.from_numpy(t.table)[a["tokens"][:, :-1].long()]
    assert (nxt == a["tokens"][:, 1:, None]).any(-1).all()


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["f32", "bf16_logits", "softcap"])
def test_lm_loss_and_its_gradient_match_jax(variant):
    jc, tc = _cfgs("gemma-2b", "float32")
    kw = {"bf16_logits": {"logits_bf16": True},
          "softcap": {"final_softcap": 30.0}}.get(variant, {})
    jc, tc = dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)
    r = np.random.RandomState(1)
    h = np.asarray(r.randn(2, 1024, 64), np.float32)
    w = np.asarray(r.randn(64, 300) * 0.2, np.float32)
    tokens, mask = _batch(300, S=1024)
    jfn = lambda h, w: jloss.lm_loss(h, w, tokens, mask, jc)  # noqa: E731
    (jl, jn), (jgh, jgw) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tl, tn = tloss.lm_loss(th, tw, torch.from_numpy(tokens), torch.from_numpy(mask), tc)
    tl.backward()
    assert float(tn) == float(jn) == mask[:, :-1].sum()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    for ref, got in ((jgh, th.grad), (jgw, tw.grad)):
        if variant == "bf16_logits":
            ref, got = np.asarray(ref, np.float32), got.numpy()
            step = 2.0 ** -7 * np.maximum(np.abs(ref), np.abs(got))
            assert (np.abs(ref - got) <= step + 1e-5 * np.abs(ref).max()).all()
        else:
            assert _rel(ref, got) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-7b"])
def test_loss_fn_and_every_gradient_match_jax(arch, dtype):
    jc, tc = _cfgs(arch, dtype)
    npp = _params(arch)
    tokens, mask = _batch(tc.vocab_size)
    batch = {"tokens": tokens, "loss_mask": mask}
    (jl, jm), jg = jax.value_and_grad(partial(jstep.loss_fn, cfg=jc, rt=JAX_RT),
                                      has_aux=True)(
        jax.tree.map(jnp.asarray, npp), jax.tree.map(jnp.asarray, batch))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = {}
    for remat in (False, True):
        tp = {k: v.requires_grad_() for k, v in from_numpy_tree(npp).items()}
        tl, tm = tstep.loss_fn(tp, tb, tc, Runtime(CPU, remat=remat))
        tl.backward()
        grads[remat] = {k: v.grad for k, v in tp.items()}
    assert abs(float(tl.detach()) - float(jl)) <= GRAD_REL[dtype] * abs(float(jl))
    assert float(tm["ntok"]) == float(jm["ntok"])
    want = from_numpy_tree(jax.tree.map(np.asarray, jg))
    assert set(want) == set(grads[True])
    for k, g in want.items():
        assert _rel(g, grads[False][k]) <= GRAD_REL[dtype], k
        # remat recomputes the same ops on the same inputs: bitwise
        assert torch.equal(grads[True][k], grads[False][k]), k


def test_train_mode_runs_past_the_sliding_window():
    """gemma2's local layers at S = 2 x window: the JAX package trains
    there (its mask handles the window); train mode keeps no cache, so
    the port needs no ring rotation either."""
    jc, tc = _cfgs("gemma2-27b", "float32")
    S = 2 * tc.window
    npp = jax.tree.map(np.asarray, jax_materialize(jax_model_defs(jc),
                                                   jax.random.PRNGKey(0)))
    tokens, mask = _batch(tc.vocab_size, B=1, S=S)
    jl, _ = jstep.loss_fn(jax.tree.map(jnp.asarray, npp),
                          {"tokens": jnp.asarray(tokens),
                           "loss_mask": jnp.asarray(mask)}, jc, JAX_RT)
    for remat in (False, True):
        tl, _ = tstep.loss_fn(from_numpy_tree(npp),
                              {"tokens": torch.from_numpy(tokens),
                               "loss_mask": torch.from_numpy(mask)},
                              tc, Runtime(CPU, remat=remat))
        assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _port_state(npp, fused, resident=None):
    opt = topt.sngm(tsched.poly_power(0.5, 4), beta=0.9, weight_decay=1e-4,
                    fused=fused)
    return opt, opt.init_state(from_numpy_tree(npp))


def test_trajectory_matches_jax_train_step():
    jc, tc = _cfgs("gemma-2b", "float32")
    npp = _params("gemma-2b")
    data = JaxSyntheticLM(jc.vocab_size, 32, 4, branching=4)
    batches = [jax.tree.map(np.asarray, data.batch_at(t)) for t in range(4)]
    jo = jopt.sngm(jsched.poly_power(0.5, 4), beta=0.9, weight_decay=1e-4)
    jfn = jax.jit(jstep.make_train_step(jc, JAX_RT, jo, n_micro=2))
    js = jo.init_state(jax.tree.map(jnp.asarray, npp))
    want = []
    for b in batches:
        js, st = jfn(js, jax.tree.map(jnp.asarray, b))
        want.append({k: float(st[k]) for k in ("loss", "grad_norm", "lr")})
    runs = {}
    for fused in (None, "multi_tensor"):
        opt, ts = _port_state(npp, fused)
        fn = tstep.make_train_step(tc, Runtime(CPU), opt, n_micro=2)
        got = []
        for b in batches:
            ts, st = fn(ts, {k: torch.from_numpy(v.copy()) for k, v in b.items()})
            got.append({k: float(st[k]) for k in ("loss", "grad_norm", "lr")})
        runs[fused] = (got, ts)
        for w, g in zip(want, got):
            for k in w:
                assert abs(w[k] - g[k]) <= 1e-5 * abs(w[k]), (fused, k, w, g)
    (ga, ta), (gb, tb) = runs[None], runs["multi_tensor"]
    assert ga == gb
    pa, pb = ta.params_view, tb.params_view
    assert all(torch.equal(pa[k].view(torch.int32), pb[k].view(torch.int32))
               for k in pa)


def test_resident_leaves_and_grads_are_views_into_the_flat_buffers():
    npp = _params("gemma-2b")
    _, ts = _port_state(npp, "multi_tensor")
    params, flat = tstep._grad_leaves(ts)

    def inside(t, bufs):
        lo, hi = t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()
        return any(b.data_ptr() <= lo and hi <= b.data_ptr() + b.numel() * b.element_size()
                   for b in bufs)
    for k, v in params.items():
        assert v.requires_grad and v.is_leaf
        assert inside(v, ts.opt_state.p_flats), k
        assert inside(v.grad, flat.flats), k
    jc, tc = _cfgs("gemma-2b", "float32")
    tokens, mask = _batch(tc.vocab_size)
    loss, _ = tstep.loss_fn(params, {"tokens": torch.from_numpy(tokens),
                                     "loss_mask": torch.from_numpy(mask)},
                            tc, Runtime(CPU))
    loss.backward()
    assert all(bool((f != 0).any()) for f in flat.flats)
    assert torch.equal(flat.tree["embed"], params["embed"].grad)


@pytest.mark.parametrize("resident", [False, True])
def test_train_state_crosses_from_jax_and_back_bitwise(resident):
    npp = _params("gemma-2b")
    bf = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.ndim == 1 else a, npp)
    bf = jax.tree.map(np.asarray, bf)
    mom = jax.tree.map(lambda a: np.asarray(a, np.float32) * 0.5, npp)
    ts = train_state_from_numpy(bf, mom, 3, resident=resident)
    assert isinstance(ts.opt_state, tmt.FlatOptState if resident else topt.OptState)
    assert (ts.params is None) == resident and ts.step == 3
    p, u, step = train_state_to_numpy(ts)
    assert step == 3
    for a, b in ((bf, p), (mom, u)):
        fa, fb = from_numpy_tree(a), from_numpy_tree(b)
        assert all(fa[k].dtype == fb[k].dtype and
                   torch.equal(fa[k].view(torch.int16) if fa[k].dtype == torch.bfloat16
                               else fa[k].view(torch.int32),
                               fb[k].view(torch.int16) if fb[k].dtype == torch.bfloat16
                               else fb[k].view(torch.int32)) for k in fa)


# ---------------------------------------------------------------------------
# tracker
# ---------------------------------------------------------------------------

def test_tracker_stack_and_callback_runner(tmp_path):
    mem = MemoryTracker()
    path = str(tmp_path / "m.jsonl")
    runner = CallbackRunner(CompositeTracker([mem, JsonlTracker(path)]),
                            [StepTimer(tokens_per_step=10)], flush_every=2)
    for t in range(3):
        runner.push(t, {"loss": torch.tensor(1.0 + t), "n": torch.tensor(t)})
    assert len(mem.steps) == 2            # flushed at step 1
    runner.close({"final": 1.5})
    assert mem.series("loss") == [1.0, 2.0, 3.0] and mem.finished
    recs = read_jsonl(path)
    assert [r.get("step") for r in recs] == [0, 1, 2, None]
    assert recs[-1]["summary"] and recs[-1]["final"] == 1.5
    assert all("tokens_per_s" in r and "_t_wall" not in r for r in recs[:3])
    with pytest.raises(TypeError):
        scalarize(torch.zeros(2))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

LINE = re.compile(r"^  step +\d+ loss=\d+\.\d{4} \|\|g\|\|=\d+\.\d{3} "
                  r"lr=\d+\.\d{4} \(\d+\.\d{2} it/s\)$")


def test_launcher_prints_the_jax_launchers_lines_and_fused_equals_none(capsys):
    outs = {}
    for fused in ("none", "multi_tensor"):
        losses = launcher.main(["--arch", "gemma-2b", "--reduced", "--device",
                                "cpu", "--steps", "2", "--batch", "4", "--seq",
                                "32", "--log-every", "1", "--fused", fused])
        lines = capsys.readouterr().out.splitlines()
        assert lines[0].startswith("[train] gemma-2b-smoke: 1,377,536 params")
        steps = [l for l in lines if l.startswith("  step")]
        assert len(steps) == 2 and all(LINE.match(l) for l in steps), steps
        assert len(losses) == 2 and all(np.isfinite(losses))
        outs[fused] = [l.split(" (")[0] for l in steps]
    assert outs["none"] == outs["multi_tensor"]


def test_launcher_accepts_and_runs_per_leaf(capsys):
    args = launcher.parse_args(["--reduced", "--device", "cpu", "--fused", "per_leaf"])
    assert args.fused == "per_leaf"
    losses = launcher.main(["--arch", "gemma-2b", "--reduced", "--device", "cpu",
                            "--steps", "1", "--batch", "4", "--seq", "32",
                            "--log-every", "1", "--fused", "per_leaf"])
    steps = [l for l in capsys.readouterr().out.splitlines() if l.startswith("  step")]
    assert len(steps) == 1 and LINE.match(steps[0]) and np.isfinite(losses[0])


@pytest.mark.parametrize("flags", [["--pod-axis", "2"],
                                   ["--data-dir", "d", "--resume", "--ckpt", "x"],
                                   ["--data-dir", "d"],
                                   ["--ema-decay", "0.9"], ["--model-axis", "2"]])
def test_launcher_refuses_what_is_not_ported(flags, capsys, tmp_path):
    if "--ema-decay" in flags:
        # ported since (EMA shadow parameters): the flag reaches sngm's
        # builder as the JAX launcher passes it, and the run builds
        args = launcher.parse_args(["--reduced", "--device", "cpu", *flags])
        assert args.ema_decay == 0.9
        spec = launcher.spec_from_args(args, 10)
        assert spec.kwargs["ema_decay"] == 0.9
        opt = launcher.build(args, spec).opt
        assert opt.plan.describe().endswith("ema[0]:0.9")
        return
    if "--data-dir" in flags:
        # ported since (repro_torch.data): the flag parses, and a
        # directory that is not a pack is refused when the run is built
        args = launcher.parse_args(["--reduced", "--device", "cpu", *[
            str(tmp_path / f) if f in ("d", "x") else f for f in flags]])
        with pytest.raises(FileNotFoundError, match="is not a packed dataset"):
            launcher.build(args)
        return
    with pytest.raises(SystemExit):
        launcher.parse_args(["--reduced", "--device", "cpu", *flags])
    assert "not ported yet" in capsys.readouterr().err


def test_launcher_raises_without_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = launcher.parse_args(["--arch", "gemma-2b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        launcher.build(args)


def test_training_modules_import_no_jax_and_nothing_of_repro():
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import repro_torch.launch.train, repro_torch.convert, "
            "repro_torch.kernels.multi_tensor.ops, repro_torch.core.multi_tensor, "
            "repro_torch.kernels.fused_sngm.ops, repro_torch.kernels.fused_lars.ops, "
            "repro_torch.training, repro_torch.tracker.callbacks, repro_torch.data\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
