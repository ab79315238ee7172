"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint``): one on-disk format, read both ways.

Every state form of the port saves the JAX package's archive keys,
``meta.json`` (byte for byte) and leaf dtypes for the same params and
optimizer, and comes back bitwise, fp32 and bf16: ``OptState``
(``fused=None``, ``per_leaf``), the resident momentum state, LAMB on the
engine and on the plain path (saved as the interpreter's
``ChainOptState``), a mid-chain clip on the ``("chain", slots)`` form,
and SNGM with EMA shadow parameters (``sngm(ema_decay=)``) on the engine
(resident ``e_flats``) and on the interpreter, keyed ``opt/.inner/[4]/
.ema/...`` as the JAX launcher saves them.  Checkpoints cross both ways
bitwise, the EMA states in every pairing of the two packages' forms.  The rest are the JAX
package's own checkpoint tests (``tests/test_checkpoint.py``,
``tests/test_data_pipeline.py``) on the port: torn saves, swaps, clobber
guards, casts, legacy archives, retention and async saves, plus an
async save followed at once by a step that rewrites the resident
buffers in place.
"""
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import ml_dtypes

from repro.checkpoint import io as jio
from repro.core import optim as jopt
from repro.core import schedules as JS
from repro.core import transform as JT
from repro_torch.checkpoint import io as tio
from repro_torch.checkpoint import (AsyncCheckpointer, is_committed,
                                    load_checkpoint, load_loader_state,
                                    resolve_checkpoint, save_checkpoint,
                                    step_dir)
from repro_torch.convert import from_numpy_tree
from repro_torch.core import multi_tensor as tmt
from repro_torch.core import optim as topt
from repro_torch.core import schedules as TS
from repro_torch.core import transform as TT
from repro_torch.launch.train import _restore

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
SHAPES = {"blocks": {"wq": (2, 16, 8), "norm": (2, 16)}, "embed": (64, 16),
          "final_norm": {"scale": (16,)}, "gain": ()}
CONST = {"name": "constant", "kwargs": {"lr": 0.1}}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def np_tree(dtype, seed=0, shapes=SHAPES):
    rng = np.random.default_rng(seed)

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        return rng.standard_normal(node).astype(np.float32).astype(DTYPES[dtype])
    return draw(shapes)


def port_tree(tree):
    return {k: v.clone() for k, v in from_numpy_tree(tree).items()}


def bits(x) -> np.ndarray:
    """A tensor's or array's bits as a numpy array (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x


def leaves(tree):
    """{key path: leaf} of a tree in the port's or the JAX package's form
    (the port's walk keys both as the JAX package does)."""
    return tio._flatten(tree)


def assert_same(a, b):
    la, lb = leaves(a), leaves(b)
    assert list(la) == list(lb)
    for k in la:
        x, y = la[k], lb[k]
        if isinstance(x, int) or isinstance(y, int):
            assert int(np.asarray(x)) == int(np.asarray(y)), k
            continue
        bx, by = bits(x), bits(y)
        assert bx.dtype == by.dtype and bx.shape == by.shape, (k, bx.dtype, by.dtype)
        np.testing.assert_array_equal(bx, by, err_msg=k)


# ---------------------------------------------------------------------------
# every state form: keys, meta and dtypes as the JAX package's; round trip
# ---------------------------------------------------------------------------

def mid_clip(T, S):
    """adw -> normalize -> clip -> trace -> schedule: a segment plan, the
    ``("chain", slots)`` resident form."""
    return T.chain(T.add_decayed_weights(1e-4), T.normalize_by_global_norm(),
                   T.clip_by_global_norm(5.0), T.trace(0.9),
                   T.scale_by_schedule(S.constant(0.1)))


FORMS = {"sngm_none": ("sngm", None), "sngm_per_leaf": ("sngm", "per_leaf"),
         "sngm_engine": ("sngm", "multi_tensor"), "lamb_none": ("lamb", None),
         "lamb_engine": ("lamb", "multi_tensor"), "mid_clip_chain": None,
         "ema_none": ("sngm", None), "ema_engine": ("sngm", "multi_tensor")}
# the builder keywords a form adds to the two above
EXTRA = {"ema_none": {"ema_decay": 0.99}, "ema_engine": {"ema_decay": 0.99}}
EMA_KEYS = ("opt/.inner/[2]/.momentum/", "opt/.inner/[3]/.count",
            "opt/.inner/[4]/.ema/")


def make_opts(form):
    """The port's and the JAX package's optimizer for one state form."""
    if FORMS[form] is None:
        return (TT.compile_chain(mid_clip(TT, TS), fused="multi_tensor"),
                JT.compile_chain(mid_clip(JT, JS), fused="multi_tensor"))
    name, fused = FORMS[form]
    kw = dict(weight_decay=1e-4, fused=fused, **EXTRA.get(form, {}))
    return (topt.make_optimizer(name, CONST, **kw),
            jopt.make_optimizer(name, JS.make_schedule(CONST), **kw))


def flat_slots(state):
    """Every resident buffer of a ``FlatOptState``, by field, the EMA
    stages' buffers one after the other."""
    return {name: [f for e in getattr(state, name) for f in e]
            if name == "e_flats" else list(getattr(state, name))
            for name in ("p_flats", "u_flats", "m_flats", "v_flats",
                         "e_flats")}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("form", sorted(FORMS))
def test_state_form_saves_the_jax_format_and_round_trips_bitwise(form, dtype,
                                                                  tmp_path):
    """After one step (non-zero slots): the port's archive has the JAX
    package's keys and dtypes and its meta.json byte for byte; the JAX
    package loads it bitwise; ``--resume``'s restore brings every bit
    and the step back in the live form, padding included."""
    npp = np_tree(dtype)
    grads = port_tree(np_tree(dtype, seed=1))
    topt_, jopt_ = make_opts(form)
    ts = topt_.init_state(port_tree(npp))
    ts, _ = topt_.step_state(grads, ts)
    port_ck = str(tmp_path / "port")
    save_checkpoint(port_ck, {"params": ts.params_view, "opt": ts.opt_state},
                    step=1)

    jparams = jax.tree.map(jnp.asarray, npp)
    jlike = {"params": jparams, "opt": jopt.to_pytree(jopt_.init(jparams))}
    jio.save_checkpoint(str(tmp_path / "jax"), jlike, step=1)
    keys = [set(np.load(tmp_path / d / "shard_00000.npz").files)
            for d in ("port", "jax")]
    assert keys[0] == keys[1]
    if form.startswith("ema"):
        assert all(any(k.startswith(e) for k in keys[0]) for e in EMA_KEYS)
    meta = [(tmp_path / d / "meta.json").read_text() for d in ("port", "jax")]
    assert meta[0] == meta[1]
    assert json.loads(meta[0])["format"] == 3

    want = {"params": ts.params_view, "opt": topt.to_pytree(ts.opt_state)}
    from_jax, step = jio.load_checkpoint(port_ck, jlike)
    assert step == 1
    assert_same(want, from_jax)

    fresh = topt_.init_state(port_tree(np_tree(dtype, seed=2)))
    restored, step = _restore(port_ck, fresh.params_view, fresh.opt_state)
    assert step == 1
    assert type(restored["opt"]) is type(ts.opt_state)
    assert_same(want, {"params": restored["params"],
                       "opt": topt.to_pytree(restored["opt"])})
    if isinstance(ts.opt_state, tmt.FlatOptState):
        a, b = ts.opt_state, restored["opt"]
        assert a.form == b.form and a.step == b.step
        fa, fb = flat_slots(a), flat_slots(b)
        for name in fa:
            assert len(fa[name]) == len(fb[name])
            for x, y in zip(fa[name], fb[name]):
                np.testing.assert_array_equal(bits(x), bits(y))


@pytest.mark.parametrize("form", ["sngm_engine", "lamb_engine", "mid_clip_chain",
                                  "lamb_none", "ema_engine"])
def test_to_pytree_from_pytree_identity(form):
    """``from_pytree(to_pytree(s), params)`` rebuilds a stepped resident
    state bit for bit (its form too); a plain LambState comes back from
    its chain form as itself."""
    topt_, _ = make_opts(form)
    ts = topt_.init_state(port_tree(np_tree("bfloat16")))
    ts, _ = topt_.step_state(port_tree(np_tree("bfloat16", seed=1)), ts)
    s = ts.opt_state
    if isinstance(s, topt.LambState):
        back = topt.lamb_state_of(topt.to_pytree(s))
        assert back.form == s.form and back.step == s.step
        assert all(back.m[k] is s.m[k] and back.v[k] is s.v[k] for k in s.m)
        return
    back = topt.from_pytree(topt.to_pytree(s), s.params)
    assert back.form == s.form and back.step == s.step == 1
    fs, fb = flat_slots(s), flat_slots(back)
    for name in fs:
        assert len(fb[name]) == len(fs[name])
        for x, y in zip(fs[name], fb[name]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(bits(x), bits(y))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["sngm", "lamb"])
def test_jax_saved_checkpoint_loads_in_the_port_bitwise(name, dtype, tmp_path):
    """The JAX package steps and saves; the port restores it into its
    resident engine state: every param, momentum and Adam-moment bit and
    the step; the port's save of that state reads back in JAX bitwise."""
    npp = np_tree(dtype)
    jparams = jax.tree.map(jnp.asarray, npp)
    jg = jax.tree.map(jnp.asarray, np_tree(dtype, seed=1))
    jo = jopt.make_optimizer(name, JS.make_schedule(CONST), weight_decay=1e-4)
    jp, js, _ = jo.step(jg, jo.init(jparams), jparams)
    jp, js, _ = jo.step(jg, js, jp)
    jtree = {"params": jp, "opt": js}
    jio.save_checkpoint(str(tmp_path / "jax"), jtree, step=2)

    to = topt.make_optimizer(name, CONST, weight_decay=1e-4, fused="multi_tensor")
    fresh = to.init_state(port_tree(npp))
    restored, step = _restore(str(tmp_path / "jax"), fresh.params_view,
                              fresh.opt_state)
    assert step == 2 and restored["opt"].step == 2
    got = {"params": restored["params"], "opt": topt.to_pytree(restored["opt"])}
    assert_same(jtree, got)

    save_checkpoint(str(tmp_path / "port"), got, step=2)
    back, step = jio.load_checkpoint(str(tmp_path / "port"), jtree)
    assert step == 2
    assert_same(jtree, back)


@pytest.mark.parametrize("port_fused", [None, "multi_tensor"])
@pytest.mark.parametrize("jax_fused", [None, "multi_tensor"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ema_checkpoints_cross_both_ways_bitwise(dtype, jax_fused, port_fused,
                                                 tmp_path):
    """SNGM with EMA: the JAX package steps twice and saves its state's
    pytree form (as its launcher does), interpreter or engine; the port
    restores it into either of its forms, every bit (the f32 shadows of
    bf16 params too) and the step; the port's save of that state has
    the JAX save's keys, dtypes and ``meta.json`` and reads back in JAX
    bitwise, into its engine form as well."""
    npp = np_tree(dtype)
    jparams = jax.tree.map(jnp.asarray, npp)
    jg = jax.tree.map(jnp.asarray, np_tree(dtype, seed=1))
    jo = jopt.make_optimizer("sngm", JS.make_schedule(CONST), weight_decay=1e-4,
                             ema_decay=0.99, fused=jax_fused)
    js, jp = jo.init(jparams), jparams
    for _ in range(2):
        jp, js, _ = jo.step(jg, js, jp if jax_fused is None else None)
    if jax_fused is not None:
        jp = js.params
    jtree = {"params": jp, "opt": jopt.to_pytree(js)}
    jio.save_checkpoint(str(tmp_path / "jax"), jtree, step=2)

    to = topt.make_optimizer("sngm", CONST, weight_decay=1e-4, ema_decay=0.99,
                             fused=port_fused)
    fresh = to.init_state(port_tree(np_tree(dtype, seed=2)))
    restored, step = _restore(str(tmp_path / "jax"), fresh.params_view,
                              fresh.opt_state)
    assert step == 2 and restored["opt"].step == 2
    assert type(restored["opt"]) is type(fresh.opt_state)
    got = {"params": restored["params"], "opt": topt.to_pytree(restored["opt"])}
    assert_same(jtree, got)

    save_checkpoint(str(tmp_path / "port"), got, step=2)
    keys = [np.load(tmp_path / d / "shard_00000.npz").files
            for d in ("port", "jax")]
    assert keys[0] == keys[1]
    assert all(any(k.startswith(e) for k in keys[0]) for e in EMA_KEYS)
    assert (tmp_path / "port" / "meta.json").read_text() == \
        (tmp_path / "jax" / "meta.json").read_text()
    back, step = jio.load_checkpoint(str(tmp_path / "port"), jtree)
    assert step == 2
    assert_same(jtree, back)
    if jax_fused is not None:
        flat = jopt.from_pytree(back["opt"], back["params"])
        for a, b in zip(js.e_flats[0] + js.p_flats, flat.e_flats[0] + flat.p_flats):
            np.testing.assert_array_equal(bits(a), bits(b))


def test_checkpoint_code_needs_no_ml_dtypes_jax_or_repro(tmp_path):
    """bf16 saves and loads with ``ml_dtypes`` unimportable, and importing
    the checkpoint package pulls in neither jax nor the JAX package."""
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import torch\n"
        "from repro_torch.checkpoint import save_checkpoint, load_checkpoint\n"
        "w = torch.randn(5, 3).to(torch.bfloat16)\n"
        f"save_checkpoint({str(tmp_path / 'ck')!r}, {{'w': w}}, step=4)\n"
        f"r, s = load_checkpoint({str(tmp_path / 'ck')!r}, {{'w': torch.zeros(5, 3, dtype=torch.bfloat16)}})\n"
        "assert s == 4 and r['w'].dtype == torch.bfloat16 and torch.equal(r['w'], w)\n"
        "assert 'ml_dtypes' not in [m for m in sys.modules if sys.modules[m] is not None]\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    meta = json.loads((tmp_path / "ck" / "meta.json").read_text())
    assert meta["dtypes"] == {"w": "bfloat16"}
    assert np.load(tmp_path / "ck" / "shard_00000.npz")["w"].dtype == np.uint16


# ---------------------------------------------------------------------------
# the JAX package's checkpoint tests, on the port
# ---------------------------------------------------------------------------

def small(dtype=torch.float32):
    return {"w": torch.arange(8, dtype=torch.float32).to(dtype),
            "b.c": torch.ones(3, dtype=dtype)}


def test_restored_leaf_cast_to_like_dtype_and_missing_leaf_raises(tmp_path):
    """Restore CASTS to the template's dtype (an fp32 checkpoint loads
    into a bf16 template as bf16), and a leaf the template expects but
    the archive lacks raises KeyError."""
    save_checkpoint(str(tmp_path / "ck"), small(), step=0)
    restored, _ = load_checkpoint(str(tmp_path / "ck"), small(torch.bfloat16))
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].float(), torch.arange(8.0))
    with pytest.raises(KeyError, match="lacks 1 leaves"):
        load_checkpoint(str(tmp_path / "ck"), {**small(), "x": torch.zeros(1)})


def test_legacy_void_checkpoint_rescued(tmp_path):
    """Pre-sidecar checkpoints stored bf16 as |V2 with no marker: the bits
    come back through the template's dtype."""
    w = torch.randn(6, 3).to(torch.bfloat16)
    os.makedirs(tmp_path / "ck")
    void = w.view(torch.int16).numpy().view("V2")
    np.savez(tmp_path / "ck" / "shard_00000.npz", w=void)
    assert np.load(tmp_path / "ck" / "shard_00000.npz")["w"].dtype.kind == "V"
    json.dump({"step": 5, "n_leaves": 1}, open(tmp_path / "ck" / "meta.json", "w"))
    restored, step = load_checkpoint(str(tmp_path / "ck"), {"w": w})
    assert step == 5 and restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"], w)


def test_save_is_committed_and_torn_saves_are_refused(tmp_path):
    path = tmp_path / "ck"
    save_checkpoint(str(path), small(), step=3)
    assert is_committed(str(path))
    assert not os.path.exists(str(path) + ".tmp-staging")
    save_checkpoint(str(path), small(), step=4)          # over an old one
    assert load_checkpoint(str(path), small())[1] == 4
    # markerless but complete (meta matches archive) = legacy, loads
    os.remove(path / "COMMIT")
    assert load_checkpoint(str(path), small())[1] == 4
    # markerless AND meta/archive mismatch = torn, refused
    meta = json.load(open(path / "meta.json"))
    meta["n_leaves"] += 1
    json.dump(meta, open(path / "meta.json", "w"))
    with pytest.raises(ValueError, match="COMMIT"):
        load_checkpoint(str(path), small())
    # torn: the meta sidecar never landed; --resume refuses it too
    os.remove(path / "meta.json")
    with pytest.raises(ValueError, match="COMMIT"):
        load_checkpoint(str(path), small())
    with pytest.raises(SystemExit, match="COMMIT"):
        _restore(str(path), small(), topt.OptState(0, small()))


def test_interrupted_swap_recovered_on_load_and_save(tmp_path):
    tree = small()
    path = tmp_path / "ck"
    save_checkpoint(str(path), tree, step=7)
    shutil.move(str(path), str(path) + ".tmp-staging")
    restored, step = load_checkpoint(str(path), tree)
    assert step == 7 and os.path.isdir(path)
    assert not os.path.exists(str(path) + ".tmp-staging")
    assert_same(tree, restored)
    shutil.move(str(path), str(path) + ".tmp-old")
    save_checkpoint(str(path), tree, step=8)
    assert load_checkpoint(str(path), tree)[1] == 8
    assert not os.path.exists(str(path) + ".tmp-old")


@pytest.mark.parametrize("target", ["file", "dir"])
def test_save_refuses_to_clobber_what_is_not_a_checkpoint(target, tmp_path):
    path = tmp_path / "precious"
    if target == "file":
        path.write_text("{}")
    else:
        os.makedirs(path)
        (path / "notes.txt").write_text("not a checkpoint")
    with pytest.raises(ValueError, match="look like a checkpoint"):
        save_checkpoint(str(path), small(), step=0)
    kept = path if target == "file" else path / "notes.txt"
    assert kept.read_text() == ("{}" if target == "file" else "not a checkpoint")
    assert not os.path.exists(str(path) + ".tmp-staging")


def test_retention_prunes_only_committed_step_dirs_and_keeps_best(tmp_path):
    base = str(tmp_path)
    tree = {"w": torch.arange(3, dtype=torch.float32)}
    os.makedirs(tmp_path / "not_a_ckpt")
    (tmp_path / "not_a_ckpt" / "data.txt").write_text("keep me")
    for s, m in [(1, 3.0), (2, 1.5), (3, 2.0), (4, 1.9), (5, 1.8)]:
        save_checkpoint(step_dir(base, s), tree, s, keep_last_n=2, metric=m,
                        loader_state={"cursor": s})
    names = sorted(os.listdir(base))
    assert "not_a_ckpt" in names
    # newest two plus the (older) best target survive
    assert [n for n in names if n.startswith("step_")] == [
        "step_00000002", "step_00000004", "step_00000005"]
    assert os.readlink(os.path.join(base, "best")) == "step_00000002"
    assert os.readlink(os.path.join(base, "latest")) == "step_00000005"
    assert load_loader_state(step_dir(base, 4)) == {"cursor": 4}
    assert json.load(open(os.path.join(base, "step_00000002",
                                       "meta.json")))["metric"] == 1.5


def test_resolve_checkpoint_layouts(tmp_path):
    tree = {"w": torch.zeros(2)}
    direct = str(tmp_path / "direct")
    save_checkpoint(direct, tree)
    assert resolve_checkpoint(direct) == direct
    assert load_loader_state(direct) is None
    base = str(tmp_path / "family")
    save_checkpoint(step_dir(base, 3), tree, 3, keep_last_n=0)
    save_checkpoint(step_dir(base, 7), tree, 7, keep_last_n=0)
    assert resolve_checkpoint(base) == os.path.join(base, "step_00000007")
    os.remove(os.path.join(base, "latest"))
    assert resolve_checkpoint(base) == os.path.join(base, "step_00000007")
    missing = str(tmp_path / "nope")
    assert resolve_checkpoint(missing) == missing


def test_async_save_never_blocks_on_commit_and_commits_in_order(tmp_path):
    tree = {"w": torch.arange(1024, dtype=torch.float32)}
    path = str(tmp_path / "ck")
    with AsyncCheckpointer(commit_delay_s=0.4) as ac:
        t0 = time.perf_counter()
        ac.save(path, tree, step=5)
        assert time.perf_counter() - t0 < 0.2   # not the 0.4 s commit
        assert not is_committed(path)
        ac.wait()
        assert is_committed(path)
    restored, step = load_checkpoint(path, tree)
    assert step == 5 and torch.equal(restored["w"], tree["w"])
    base = str(tmp_path / "family")
    with AsyncCheckpointer() as ac:
        for s in (1, 2, 3):
            ac.save(step_dir(base, s), {"w": torch.full((2,), float(s))},
                    step=s, keep_last_n=0)
    assert os.readlink(os.path.join(base, "latest")) == "step_00000003"


def test_async_save_reraises_background_failure(tmp_path):
    bad = tmp_path / "not_ckpt"
    bad.mkdir()
    (bad / "something.txt").write_text("user data")
    ac = AsyncCheckpointer()
    ac.save(str(bad), {"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="refusing to overwrite"):
        ac.wait()
    ac.close()
    assert (bad / "something.txt").read_text() == "user data"


@pytest.mark.parametrize("name", ["sngm", "lamb"])
def test_async_save_then_a_step_at_once_saves_the_step_boundary(name, tmp_path):
    """The next step rewrites the resident buffers in place while the
    commit is still delayed: the snapshot was complete when ``save()``
    returned, so the checkpoint holds the pre-step bits."""
    to = topt.make_optimizer(name, CONST, weight_decay=1e-4, fused="multi_tensor")
    ts = to.init_state(port_tree(np_tree("float32")))
    grads = port_tree(np_tree("float32", seed=1))
    ts, _ = to.step_state(grads, ts)
    before = {k: v.clone() for k, v in
              leaves({"params": ts.params_view,
                      "opt": topt.to_pytree(ts.opt_state)}).items()
              if isinstance(v, torch.Tensor)}
    path = str(tmp_path / "ck")
    with AsyncCheckpointer(commit_delay_s=0.3) as ac:
        ac.save(path, {"params": ts.params_view, "opt": ts.opt_state}, step=1)
        ts, _ = to.step_state(grads, ts)             # in place, at once
        assert not is_committed(path)
    fresh = to.init_state(port_tree(np_tree("float32", seed=2)))
    restored, step = _restore(path, fresh.params_view, fresh.opt_state)
    got = leaves({"params": restored["params"],
                  "opt": topt.to_pytree(restored["opt"])})
    assert step == 1 and restored["opt"].step == 1
    for k, v in before.items():
        np.testing.assert_array_equal(bits(got[k]), bits(v), err_msg=k)
    assert not torch.equal(ts.params_view["embed"], before["params/embed"])
