"""Save and resume through the port's train launcher
(``repro_torch.launch.train``), and across to the JAX launcher.

gemma-2b smoke on the CPU, torch at 2 threads.  Held:

  * a run split by ``--ckpt`` / ``--resume`` prints the uninterrupted
    run's step lines (loss, ||g||, lr), bitwise, for SNGM and LAMB on the
    engine, resumed on the engine and under ``--fused none``; and so does
    a ``--save-every 1 --keep-last-n 1 --async-save`` family resumed from
    its base;
  * for the same flags the two launchers write the same
    ``train_meta.json``, byte for byte;
  * the port resumes the JAX launcher's checkpoint: the restored state
    is bitwise what JAX saved, the saved optimizer spec and horizon are
    adopted, and the lr of every resumed step is the JAX schedule's
    (later losses are not held: the smoke run is chaotic, ROADMAP C1);
  * the JAX launcher resumes the port's checkpoint;
  * ``--ema-decay``: a split ``--fused multi_tensor`` run prints the
    uninterrupted run's lines and saves its final checkpoint bit for bit,
    the EMA shadows included (resumed on the engine and under ``--fused
    none``); the two launchers write the same ``train_meta.json``; a
    checkpoint of either launcher resumes in both, and the two continue
    to the same EMA bits (decay 0.5: exact products, so the JAX
    package's compiled step, which may fuse a multiply-add, rounds as
    the port does);
  * ``--data-dir``: a ``--prefetch 2 --save-every 2 --async-save`` run
    split by ``--resume`` (resumed with prefetch or without) prints the
    uninterrupted run's step lines bitwise, and every checkpoint's
    ``loader_state`` is the host loader's cursor after that many batches
    (the prefetcher's, never the loader's run-ahead position);
  * a ``--data-dir`` checkpoint of either launcher resumes in the other:
    the resumed stream stands at the saved cursor, and its next batch is
    bitwise the other package's loader's batch from there.
"""
import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import repro.data as jdata
import repro.launch.train as jax_launcher
from repro.checkpoint import load_loader_state as jax_load_loader_state
from repro.core import schedules as JS
from repro_torch import data as tdata
from repro_torch.checkpoint import io as tio
from repro_torch.core import optim as topt
from repro_torch.launch import train as launcher

BASE = ["--arch", "gemma-2b", "--reduced", "--batch", "4", "--seq", "16",
        "--n-micro", "2", "--log-every", "1"]
RUNS = {"sngm": ["--optimizer", "sngm", "--lr", "0.5"],
        "lamb": ["--optimizer", "lamb", "--lr", "0.01"]}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(main, argv):
    """The launcher's step lines without their timing, and its stdout."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    text = out.getvalue()
    return [l.split(" (")[0] for l in text.splitlines()
            if l.startswith("  step")], text


def port(argv):
    return run(launcher.main, BASE + ["--device", "cpu"] + argv)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_split_run_prints_the_uninterrupted_lines(name, tmp_path):
    """4 steps uninterrupted against 2 + save + resume for 2 more: on the
    engine, and from the same checkpoint under ``--fused none``."""
    flags = RUNS[name] + ["--fused", "multi_tensor"]
    full, _ = port(flags + ["--steps", "4"])
    ck = str(tmp_path / "ck")
    first, _ = port(flags + ["--steps", "2", "--total-steps", "4", "--ckpt", ck])
    assert first == full[:2]
    shutil.copytree(ck, str(tmp_path / "ck_plain"))
    resumed, text = port(flags + ["--steps", "4", "--ckpt", ck, "--resume"])
    assert f"[train] resumed {ck} at step 2" in text
    assert resumed == full[2:]
    plain, _ = port(RUNS[name] + ["--fused", "none", "--steps", "4", "--ckpt",
                                  str(tmp_path / "ck_plain"), "--resume"])
    assert plain == full[2:]


def test_async_family_resumes_from_its_base(tmp_path):
    flags = RUNS["sngm"] + ["--fused", "multi_tensor"]
    full, _ = port(flags + ["--steps", "4"])
    base = str(tmp_path / "family")
    port(flags + ["--steps", "2", "--total-steps", "4", "--ckpt", base,
                  "--save-every", "1", "--keep-last-n", "1", "--async-save"])
    assert sorted(os.listdir(base)) == ["latest", "step_00000002",
                                        "train_meta.json"]
    resumed, text = port(flags + ["--steps", "4", "--ckpt", base, "--resume",
                                  "--save-every", "1", "--keep-last-n", "1"])
    assert f"resumed {os.path.join(base, 'step_00000002')} at step 2" in text
    assert resumed == full[2:]
    assert os.readlink(os.path.join(base, "latest")) == "step_00000004"


def test_port_resumes_a_jax_launcher_checkpoint(tmp_path):
    """JAX trains msgd 2 steps of 4 and saves; the port resumes with
    other flags: it adopts msgd, lr 0.05 and the horizon 4, restores
    every bit JAX saved, and steps 2-3 run at the JAX schedule's lr."""
    ck = str(tmp_path / "ck")
    run(jax_launcher.main, BASE + ["--optimizer", "msgd", "--lr", "0.05",
                                   "--weight-decay", "1e-3", "--steps", "2",
                                   "--total-steps", "4", "--ckpt", ck])
    jax_text = open(os.path.join(ck, "train_meta.json")).read()
    jax_meta = json.loads(jax_text)
    # the port's train_meta.json for the same flags is the JAX launcher's
    port(["--optimizer", "msgd", "--lr", "0.05", "--weight-decay", "1e-3",
          "--steps", "2", "--total-steps", "4", "--ckpt", str(tmp_path / "p")])
    assert open(tmp_path / "p" / "train_meta.json").read() == jax_text
    args = launcher.parse_args(BASE + ["--device", "cpu", "--steps", "4",
                                       "--fused", "multi_tensor", "--ckpt", ck,
                                       "--resume"])
    plan = launcher.plan_run(args)
    assert plan.horizon == 4 and plan.spec.name == "msgd"
    want_kw = dict(jax_meta["optimizer_spec"]["kwargs"], fused="multi_tensor")
    assert plan.spec.to_json() == {"name": "msgd", "kwargs": want_kw}
    r = launcher.build(args, plan.spec)
    start = launcher.resume(r, plan.resume_path)
    assert start == 2 and r.state.step == 2
    got = tio._flatten({"params": r.state.params_view,
                        "opt": topt.to_pytree(r.state.opt_state)})
    saved = np.load(os.path.join(ck, "shard_00000.npz"))
    assert set(got) == set(saved.files)
    for k, v in got.items():
        np.testing.assert_array_equal(np.asarray(v) if isinstance(v, int)
                                      else v.numpy(), saved[k], err_msg=k)
    _, mem = launcher.train(args, r, start)
    lrs = [m["lr"] for _, m in mem.steps]
    want = [float(JS.poly_power(0.05, 4, 1.1)(jnp.int32(t))) for t in (2, 3)]
    assert [f"{x:.4f}" for x in lrs] == [f"{x:.4f}" for x in want]
    np.testing.assert_allclose(lrs, want, rtol=4 * 2**-23)


def test_jax_launcher_resumes_a_port_checkpoint(tmp_path):
    ck = str(tmp_path / "ck")
    port(RUNS["lamb"] + ["--fused", "multi_tensor", "--steps", "2",
                         "--total-steps", "4", "--ckpt", ck])
    lines, text = run(jax_launcher.main, BASE + ["--steps", "3", "--ckpt", ck,
                                                 "--resume"])
    assert f"[train] resumed {ck} at step 2" in text
    assert len(lines) == 1 and lines[0].startswith("  step     2 ")
    assert "lr=0.0047" in lines[0]


# ------------------------------------------------------------ --ema-decay

def _archive(path):
    z = np.load(os.path.join(path, "shard_00000.npz"))
    return {k: z[k] for k in z.files}


def _same_archives(a, b, only=""):
    assert sorted(a) == sorted(b)
    keys = [k for k in a if k.startswith(only)]
    assert keys
    for k in keys:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


EMA = RUNS["sngm"] + ["--ema-decay", "0.99"]


def test_split_ema_run_matches_the_uninterrupted_run(tmp_path):
    """4 steps against 2 + save + resume for 2 more (on the engine, and
    under ``--fused none`` from the same checkpoint): the step lines and
    the final checkpoint, EMA shadows included, bit for bit."""
    flags = EMA + ["--fused", "multi_tensor", "--total-steps", "4"]
    full, _ = port(flags + ["--steps", "4", "--ckpt", str(tmp_path / "full")])
    ck = str(tmp_path / "ck")
    first, _ = port(flags + ["--steps", "2", "--ckpt", ck])
    assert first == full[:2]
    assert any(k.startswith("opt/.inner/[4]/.ema/") for k in _archive(ck))
    shutil.copytree(ck, str(tmp_path / "ck_plain"))
    resumed, text = port(flags + ["--steps", "4", "--ckpt", ck, "--resume"])
    assert f"[train] resumed {ck} at step 2" in text
    assert resumed == full[2:]
    want = _archive(str(tmp_path / "full"))
    _same_archives(want, _archive(ck))
    plain, _ = port(EMA + ["--fused", "none", "--steps", "4", "--ckpt",
                           str(tmp_path / "ck_plain"), "--resume"])
    assert plain == full[2:]
    _same_archives(want, _archive(str(tmp_path / "ck_plain")))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ema_checkpoint_resumes_in_both_launchers(writer, tmp_path):
    """One launcher trains 2 of 3 steps with ``--ema-decay 0.5`` on the
    engine and saves; each launcher resumes a copy and runs step 2.  The
    port restores every bit the checkpoint holds; both write the same
    ``train_meta.json`` for the same flags; both print step 2 at the same
    lr; and their step-3 EMA shadows are the same bits (the advance reads
    only the restored params and shadow)."""
    flags = ["--optimizer", "sngm", "--lr", "0.5", "--ema-decay", "0.5",
             "--fused", "multi_tensor", "--total-steps", "3"]
    ck = str(tmp_path / "ck")
    metas = {}
    for who, main in (("jax", lambda a: run(jax_launcher.main, BASE + a)),
                      ("port", port)):
        dest = ck if who == writer else str(tmp_path / f"meta_{who}")
        main(flags + ["--steps", "2", "--ckpt", dest])
        metas[who] = open(os.path.join(dest, "train_meta.json")).read()
    assert metas["jax"] == metas["port"]
    assert json.loads(metas["port"])["optimizer_spec"]["kwargs"]["ema_decay"] == 0.5
    for who in ("jax", "port"):
        shutil.copytree(ck, str(tmp_path / f"ck_{who}"))
    args = launcher.parse_args(BASE + ["--device", "cpu", "--steps", "3",
                                       "--fused", "multi_tensor", "--ckpt", ck,
                                       "--resume"])
    plan = launcher.plan_run(args)
    r = launcher.build(args, plan.spec)
    assert launcher.resume(r, plan.resume_path) == 2
    got = tio._flatten({"params": r.state.params_view,
                        "opt": topt.to_pytree(r.state.opt_state)})
    saved = _archive(ck)
    assert set(got) == set(saved)
    for k, v in got.items():
        np.testing.assert_array_equal(np.asarray(v) if isinstance(v, int)
                                      else v.view(torch.int16).numpy()
                                      .view(np.uint16)
                                      if v.dtype == torch.bfloat16
                                      else v.numpy(), saved[k], err_msg=k)
    lines = {}
    lines["jax"], _ = run(jax_launcher.main, BASE + [
        "--steps", "3", "--ckpt", str(tmp_path / "ck_jax"), "--resume"])
    lines["port"], _ = port(["--steps", "3", "--fused", "multi_tensor",
                             "--ckpt", str(tmp_path / "ck_port"), "--resume"])
    assert [l[:13] for l in lines["jax"]] == ["  step     2 "]
    assert lines["jax"][0].split("lr=")[1] == lines["port"][0].split("lr=")[1]
    _same_archives(_archive(str(tmp_path / "ck_jax")),
                   _archive(str(tmp_path / "ck_port")),
                   only="opt/.inner/[4]/.ema/")


# ------------------------------------------------------------ --data-dir

def _pack(tmp_path, vocab=1024, seq=16):
    """A JAX-written synthetic-LM pack at the smoke model's vocab: 64
    examples in 4 shards, 16 batches of 4 an epoch."""
    src = jdata.SyntheticLM(vocab, seq, 1, epoch_examples=64, n_shards=4)
    path = str(tmp_path / "ds")
    with jdata.DataPackWriter(path, shard_size=16,
                              meta={"vocab_size": vocab, "seq_len": seq}) as w:
        for s in range(4):
            w.add(src.read(s, 0, 16))
    return path


def _host_states(path, n):
    """The port's host loader cursor after 0..n batches (batch 4, seed 0)."""
    lo = tdata.StreamingLoader(tdata.DiskShardedSource(path), 4, seed=0)
    states = [lo.state.to_dict()]
    for _ in range(n):
        next(lo)
        states.append(lo.state.to_dict())
    return states


def _same_batch(jb, tb):
    assert sorted(jb) == sorted(tb)
    for k in jb:
        np.testing.assert_array_equal(np.asarray(jb[k]), tb[k].numpy(), err_msg=k)


@pytest.mark.parametrize("resume_prefetch", ["2", "0"])
def test_data_dir_split_run_prints_the_uninterrupted_lines(resume_prefetch,
                                                           tmp_path):
    ds = _pack(tmp_path)
    flags = RUNS["sngm"] + ["--fused", "multi_tensor", "--total-steps", "8",
                            "--data-dir", ds, "--seq", "99"]
    full, text = port(flags + ["--steps", "8", "--prefetch", "2"])
    assert len(full) == 8 and "[train] input stall" in text
    base = str(tmp_path / "ck")
    first, _ = port(flags + ["--steps", "4", "--prefetch", "2", "--ckpt", base,
                             "--save-every", "2", "--keep-last-n", "2",
                             "--async-save"])
    assert first == full[:4]
    states = _host_states(ds, 8)
    for step in (2, 4):
        assert tio.load_loader_state(os.path.join(
            base, f"step_{step:08d}")) == states[step]
    resumed, text = port(flags + ["--steps", "8", "--prefetch", resume_prefetch,
                                  "--ckpt", base, "--resume"])
    assert f"resumed {os.path.join(base, 'step_00000004')} at step 4" in text
    assert resumed == full[4:]
    assert os.readlink(os.path.join(base, "latest")) == "step_00000008"
    assert tio.load_loader_state(os.path.join(base, "step_00000008")) == states[8]


def test_port_resumes_a_jax_data_dir_checkpoint(tmp_path):
    ds = _pack(tmp_path)
    ck = str(tmp_path / "ck")
    run(jax_launcher.main, BASE + ["--optimizer", "sngm", "--steps", "3",
                                   "--total-steps", "5", "--data-dir", ds,
                                   "--ckpt", ck])
    saved = jax_load_loader_state(ck)
    assert saved == _host_states(ds, 3)[3]
    args = launcher.parse_args(BASE + ["--device", "cpu", "--steps", "5",
                                       "--data-dir", ds, "--ckpt", ck,
                                       "--resume"])
    plan = launcher.plan_run(args)
    r = launcher.build(args, plan.spec)
    assert launcher.resume(r, plan.resume_path) == 3
    assert r.data.state.to_dict() == saved
    want = jdata.StreamingLoader(jdata.DiskShardedSource(ds), 4,
                                 state=jdata.LoaderState.from_dict(saved))
    it = r.data.start()
    for _ in range(2):
        _same_batch(next(want), next(it))
    r.data.close()


def test_jax_launcher_resumes_a_port_data_dir_checkpoint(tmp_path):
    ds = _pack(tmp_path)
    ck = str(tmp_path / "ck")
    port(RUNS["sngm"] + ["--fused", "multi_tensor", "--steps", "3",
                         "--total-steps", "5", "--data-dir", ds, "--ckpt", ck])
    saved = tio.load_loader_state(ck)
    assert saved == _host_states(ds, 3)[3]
    jl = jdata.StreamingLoader(jdata.DiskShardedSource(ds), 4,
                               state=jdata.LoaderState.from_dict(saved))
    assert jl.state.to_dict() == saved
    tl = tdata.StreamingLoader(tdata.DiskShardedSource(ds), 4,
                               state=tdata.LoaderState.from_dict(saved))
    for _ in range(2):
        _same_batch(next(jl), next(tl))
    lines, text = run(jax_launcher.main, BASE + ["--steps", "5", "--data-dir",
                                                 ds, "--ckpt", ck, "--resume"])
    assert f"[train] resumed {ck} at step 3" in text
    assert [l[:13] for l in lines] == ["  step     3 ", "  step     4 "]
    assert jax_load_loader_state(ck) == _host_states(ds, 5)[5]
