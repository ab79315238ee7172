"""``repro_torch.prng`` against ``jax.random`` (threefry-2x32, the
partitionable layout of the installed jax), and what the port draws
with it: synthetic batches, initial weights, sampled tokens and the
train launcher's lines.

Bounds, and why:

  * ``PRNGKey``, ``fold_in``, ``split``, ``random_bits``, ``uniform``,
    ``randint`` and ``SyntheticLM.batch_at``: bitwise;
  * ``normal``: ``prng.NORMAL_ULP`` (3) float32 ulps, the largest gap
    over 2**24 draws; XLA's ``log1p`` inside ``erf_inv`` is not
    PyTorch's, and XLA contracts the polynomial into fused multiply-adds;
  * ``materialize``: fp32 leaves ``NORMAL_ULP + 1`` ulps (the init scale's
    product rounds once more), bf16 leaves 1 bf16 ulp, other leaves
    bitwise;
  * ``gumbel``: 2e-6 absolute (one float32 ulp at the largest draw,
    ~16); ``categorical`` and ``sample_logits``: the same token on every
    row;
  * the train launchers (``--arch gemma-2b --reduced --steps 4 --batch 4
    --seq 32 --n-micro 2 --optimizer sngm --fused multi_tensor``): the
    lr column equal at every step; loss and ||g|| at step 0 within the
    loss/gradient bound of ``tests/test_torch_train.py`` for the compute
    dtype (2e-5 relative at fp32, 5e-2 at bf16) plus the printed
    precision.  Later steps are not held: at lr 1.6 this configuration
    is chaotic, and the JAX launcher against itself, with 5 % of its
    weights moved by one ulp, departs by more than 1e-3 at step 3 (the
    test checks that as well).
"""
import contextlib
import dataclasses
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.launch.train as jax_launcher
from repro import configs as jcfg
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.models import model_defs as jax_model_defs
from repro.models.param import materialize as jax_materialize
from repro.serving.engine import sample_logits as jax_sample_logits
from repro_torch import configs as tcfg
from repro_torch import prng
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as launcher
from repro_torch.models import materialize, model_defs
from repro_torch.serving.engine import sample_logits

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SEEDS = [0, 1, 42, 2**31 - 1, 2**31, -1, 2**33 + 5, -2**40]
SHAPES = [(), (1,), (7,), (3, 5), (2, 3, 4)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _words(a):
    return np.asarray(a).astype(np.int64)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))


# ---------------------------------------------------------------------------
# keys and bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_and_split_are_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert np.array_equal(_words(jk), tk.numpy())
    for d in (0, 1, 12345, 2**31 - 1, 2**32 - 1):
        assert np.array_equal(_words(jax.random.fold_in(jk, d)),
                              prng.fold_in(tk, d).numpy()), d
    for n in (1, 2, 3, 5):
        assert np.array_equal(_words(jax.random.split(jk, n)),
                              prng.split(tk, n).numpy()), n


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 17])
def test_bits_uniform_randint_are_bitwise(seed, shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    tk = prng.fold_in(prng.PRNGKey(seed), 3)
    got = prng.random_bits(tk, shape)
    assert got.shape == shape and got.dtype == torch.int64
    assert np.array_equal(_words(jax.random.bits(jk, shape, jnp.uint32)), got.numpy())
    for lo, hi in ((0.0, 1.0), (-2.5, 3.0)):
        got = prng.uniform(tk, shape, lo, hi)
        assert got.dtype == torch.float32 and got.shape == shape
        assert _ulps(jax.random.uniform(jk, shape, jnp.float32, lo, hi),
                     got.numpy()).max(initial=0) == 0
    for lo, hi in ((0, 4), (0, 1024), (-7, 256000), (5, 5), (9, 3),
                   (-2**31, 2**31 - 1)):
        got = prng.randint(tk, shape, lo, hi)
        assert got.dtype == torch.int32 and got.shape == shape
        assert np.array_equal(
            np.asarray(jax.random.randint(jk, shape, lo, hi, jnp.int32)),
            got.numpy()), (lo, hi)


def test_chunked_draws_equal_one_draw(monkeypatch):
    monkeypatch.setattr(prng, "CHUNK", 1000)
    jk, tk = jax.random.PRNGKey(5), prng.PRNGKey(5)
    assert np.array_equal(_words(jax.random.bits(jk, (4099,), jnp.uint32)),
                          prng.random_bits(tk, (4099,)).numpy())
    assert np.array_equal(np.asarray(jax.random.randint(jk, (3, 1001), 0, 77)),
                          prng.randint(tk, (3, 1001), 0, 77).numpy())


def test_normal_within_the_measured_ulp_bound():
    for shape in SHAPES:
        jk, tk = jax.random.PRNGKey(11), prng.PRNGKey(11)
        got = prng.normal(tk, shape)
        assert got.shape == shape and got.dtype == torch.float32
        assert _ulps(jax.random.normal(jk, shape, jnp.float32),
                     got.numpy()).max(initial=0) <= prng.NORMAL_ULP
    n = 1 << 24
    jk = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    ulp = _ulps(jax.random.normal(jk, (n,), jnp.float32),
                prng.normal(prng.fold_in(prng.PRNGKey(0), 3), (n,)).numpy())
    print(f"normal vs jax.random.normal over {n} draws: max {ulp.max()} ulp, "
          f"{(ulp > 0).mean():.4f} of draws differ")
    assert ulp.max() <= prng.NORMAL_ULP


def test_gumbel_and_categorical_match_jax():
    jk, tk = jax.random.PRNGKey(2), prng.PRNGKey(2)
    jg = np.asarray(jax.random.gumbel(jk, (1 << 20,), jnp.float32, mode="low"))
    tg = prng.gumbel(tk, (1 << 20,)).numpy()
    assert np.abs(jg - tg).max() <= 2e-6
    logits = np.random.RandomState(0).randn(16, 1000).astype(np.float32) * 2
    for i in range(8):
        want = np.asarray(jax.random.categorical(jax.random.fold_in(jk, i), logits))
        got = prng.categorical(prng.fold_in(tk, i), torch.from_numpy(logits))
        assert np.array_equal(want, got.numpy()), i


@pytest.mark.parametrize("top_k", [0, 10])
def test_sample_logits_gives_the_jax_tokens(top_k):
    logits = np.random.RandomState(1).randn(8, 512).astype(np.float32) * 3
    for i, temperature in enumerate((0.7, 1.0, 1.3)):
        jk = jax.random.fold_in(jax.random.PRNGKey(4), i)
        want = np.asarray(jax_sample_logits(jnp.asarray(logits), jk,
                                            temperature, top_k))
        got = sample_logits(torch.from_numpy(logits),
                            prng.fold_in(prng.PRNGKey(4), i), temperature, top_k)
        assert got.dtype == torch.int32
        assert np.array_equal(want, got.numpy()), (temperature, top_k)


# ---------------------------------------------------------------------------
# batches, weights, launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,i", [(0, 0), (0, 1), (3, 5), (7, 123)])
def test_synthetic_batches_are_the_jax_batches(seed, i):
    j = JaxSyntheticLM(1024, 32, 4, seed=seed, branching=4).batch_at(i)
    t = SyntheticLM(1024, 32, 4, seed=seed, branching=4).batch_at(i)
    assert t["tokens"].dtype == torch.int32
    assert np.array_equal(np.asarray(j["tokens"]), t["tokens"].numpy())
    assert np.array_equal(np.asarray(j["loss_mask"]), t["loss_mask"].numpy())


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["gemma-2b", "gemma2-27b", "chameleon-34b"])
def test_materialize_matches_jax_leaf_by_leaf(arch, param_dtype):
    jc = dataclasses.replace(jcfg.smoke_variant(jcfg.ARCHS[arch]),
                             param_dtype=param_dtype)
    tc = dataclasses.replace(tcfg.smoke_variant(tcfg.ARCHS[arch]),
                             param_dtype=param_dtype)
    paths = jax.tree_util.tree_flatten_with_path(
        jax_materialize(jax_model_defs(jc), jax.random.PRNGKey(0)))[0]
    want = {".".join(str(k.key) for k in path): v for path, v in paths}
    got = materialize(model_defs(tc), prng.PRNGKey(0), CPU)
    assert sorted(want) == sorted(got)
    for k, t in got.items():
        j = np.asarray(want[k])
        assert t.shape == j.shape and str(t.dtype).split(".")[-1] == str(j.dtype), k
        if t.dtype == torch.bfloat16:
            gap = np.abs((j.astype(np.float32).view(np.int32) >> 16).astype(np.int64)
                         - (t.float().numpy().view(np.int32) >> 16))
            assert gap.max(initial=0) <= 1, k
        else:
            assert _ulps(j, t.numpy()).max(initial=0) <= prng.NORMAL_ULP + 1, k


STEP = re.compile(r"^  step +(\d+) loss=(\S+) \|\|g\|\|=(\S+) lr=(\S+) ")
LAUNCH = ["--arch", "gemma-2b", "--reduced", "--steps", "4", "--batch", "4",
          "--seq", "32", "--n-micro", "2", "--optimizer", "sngm",
          "--fused", "multi_tensor", "--log-every", "1"]


def _lines(main, argv, monkeypatch, module, compute_dtype, materialize_=None):
    """Run a launcher's ``main`` in this process; returns its step lines
    as (loss, ||g||, lr) rows."""
    with monkeypatch.context() as m:
        if compute_dtype is not None:
            smoke = module.smoke_variant
            m.setattr(module, "smoke_variant", lambda c: dataclasses.replace(
                smoke(c), compute_dtype=compute_dtype))
        if materialize_ is not None:
            m.setattr(module, "materialize", materialize_)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            main(argv)
    rows = [STEP.match(l) for l in out.getvalue().splitlines()]
    return [tuple(float(x) for x in r.groups()[1:]) for r in rows if r]


def _nudged(defs, key):
    """The JAX init with 5 % of its fp32 weights moved by one ulp."""
    r = np.random.RandomState(1)

    def nudge(a):
        a = np.asarray(a)
        if a.dtype != np.float32:
            return jnp.asarray(a)
        step = r.randint(-1, 2, a.shape) * (r.rand(*a.shape) < 0.05)
        return jnp.asarray((a.view(np.int32) + step.astype(np.int32)).view(np.float32))
    return jax.tree.map(nudge, jax_materialize(defs, key))


@pytest.mark.parametrize("compute_dtype,rel", [(None, 5e-2), ("float32", 2e-5)])
def test_train_launchers_print_the_same_first_step(compute_dtype, rel, monkeypatch):
    want = _lines(jax_launcher.main, LAUNCH, monkeypatch, jax_launcher, compute_dtype)
    got = _lines(launcher.main, LAUNCH + ["--device", "cpu"], monkeypatch,
                 launcher, compute_dtype)
    assert len(want) == len(got) == 4
    assert [w[2] for w in want] == [g[2] for g in got]          # lr, every step
    for w, g, res in zip(want[0], got[0], (5e-5, 5e-4)):       # loss, ||g||
        assert abs(w - g) <= rel * abs(w) + res, (want[0], got[0])
    if compute_dtype == "float32":
        # the configuration amplifies one-ulp weight differences past step 0
        nudged = _lines(jax_launcher.main, LAUNCH, monkeypatch, jax_launcher,
                        compute_dtype, _nudged)
        print(f"JAX launcher step-3 ||g|| {want[3][1]}, with 5 % of its weights "
              f"moved by one ulp {nudged[3][1]}; the port's {got[3][1]}")
        assert abs(nudged[3][1] - want[3][1]) > 1e-3 * want[3][1], (want, nudged)


def test_prng_imports_no_jax_and_nothing_of_repro():
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import repro_torch.prng, repro_torch.models.param, "
            "repro_torch.serving.scheduler, repro_torch.data\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
