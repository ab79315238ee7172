"""The port's training loops (``repro_torch.training.loops``) against the
JAX package's host loops (``benchmarks.common``, imported here only),
and the tracker pieces they use (``StepTimer(examples_per_step=)``, the
ambient tracker).

Bounds held, and why:

  * ``train_convnet`` (the Fig-1 network at its width, 32; n_train 256,
    n_test 64, B 64 in micro-batches of 32, 4 steps; SNGM on the engine
    and MSGD ``fused=None``, with and without ``ghost_batch=16``): the
    step-0 loss within 2e-5 relative (the same weights and batch, two
    convolution libraries); later steps within 1e-5 relative (measured
    3e-7: the updates are small); ``test_acc`` within 1/64 (one test
    image); the result keys equal;
  * ``train_lm`` (the Table-3 proxy config: deepseek-7b smoke, vocab
    256, fp32; B 16, seq 64, 2 micro-batches, 3 SNGM steps on the
    engine): the step-0 loss within 2e-5 relative; steps 1-2 within 2e-3
    relative (measured 3.2e-5 and 3.4e-4: lr 2.0 amplifies the few-ulp
    differences of the forward); ``optimal_loss`` bitwise; the same on a
    pack written by ``repro_torch.data.pack`` read with ``prefetch=2``
    (the loaders are bitwise across packages), with the input-stall
    keys; the vocab-mismatch message equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import common as jcommon
from repro.configs import ARCHS as JARCHS
from repro.configs import smoke_variant as jsmoke
from repro.core import optim as jopt
from repro.core.schedules import poly_power as jpoly
from repro.data.synthetic import synthetic_images as jax_images
from repro.tracker.callbacks import StepTimer as JaxStepTimer
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.core import optim as topt
from repro_torch.core.schedules import poly_power as tpoly
from repro_torch.data import pack, synthetic_images
from repro_torch.tracker import (MemoryTracker, NullTracker, current_tracker,
                                 set_global_tracker, with_tracker)
from repro_torch.tracker.callbacks import CallbackRunner, StepTimer
from repro_torch.training import train_convnet, train_lm

STEP0_REL = 2e-5
CONVNET_REL = 1e-5
LM_REL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def images():
    jax_sets = (*jax_images(256, seed=0), *jax_images(64, seed=99))
    port_sets = (*synthetic_images(256, seed=0), *synthetic_images(64, seed=99))
    return jax_sets, port_sets


def _rel(got, want):
    return abs(got - want) / abs(want)


@pytest.mark.parametrize("ghost", [None, 16])
@pytest.mark.parametrize("name,fused,lr", [("sngm", "multi_tensor", 0.2),
                                           ("msgd", None, 0.05)])
def test_train_convnet_matches_the_jax_loop(images, name, fused, lr, ghost):
    (x, y, xt, yt), (tx, ty, txt, tyt) = images
    kw = dict(beta=0.9, weight_decay=1e-4, fused=fused)
    want = jcommon.train_convnet(getattr(jopt, name)(jpoly(lr, 4), **kw),
                                 x, y, xt, yt, 64, 4, accum_micro=32,
                                 ghost_batch=ghost)
    mem = MemoryTracker()
    got = train_convnet(getattr(topt, name)(tpoly(lr, 4), **kw),
                        tx, ty, txt, tyt, 64, 4, accum_micro=32,
                        ghost_batch=ghost, tracker=mem, device="cpu")
    assert sorted(got) == sorted(want)
    assert len(got["losses"]) == len(want["losses"]) == 4
    assert _rel(got["losses"][0], want["losses"][0]) <= STEP0_REL
    for a, b in zip(got["losses"][1:], want["losses"][1:]):
        assert _rel(a, b) <= CONVNET_REL
    assert got["final_loss"] == got["losses"][-1]
    assert abs(got["test_acc"] - want["test_acc"]) <= 1 / 64
    assert got["diverged"] is want["diverged"] is False
    assert got["examples_per_s"] > 0 and got["wall_time_s"] > 0
    # the caller's tracker saw every step and the summary
    assert [s for s, _ in mem.steps] == [0, 1, 2, 3]
    assert mem.summary["test_acc"] == got["test_acc"] and mem.finished


def _lm_configs():
    return (dataclasses.replace(jsmoke(JARCHS["deepseek-7b"]), vocab_size=256,
                                compute_dtype="float32"),
            dataclasses.replace(smoke_variant(ARCHS["deepseek-7b"]),
                                vocab_size=256, compute_dtype="float32"))


def _lm_pair(**kw):
    jcfg, tcfg = _lm_configs()
    opt = dict(beta=0.9, weight_decay=1e-4, fused="multi_tensor")
    want = jcommon.train_lm(jopt.sngm(jpoly(2.0, 3), **opt), jcfg, 16, 64, 3,
                            n_micro=2, **kw)
    got = train_lm(topt.sngm(tpoly(2.0, 3), **opt), tcfg, 16, 64, 3,
                   n_micro=2, device="cpu", **kw)
    assert sorted(got) == sorted(want)
    assert _rel(got["losses"][0], want["losses"][0]) <= STEP0_REL
    for a, b in zip(got["losses"][1:], want["losses"][1:]):
        assert _rel(a, b) <= LM_REL
    assert len(got["losses"]) == 3 and got["tokens_per_s"] > 0
    return got, want


def test_train_lm_matches_the_jax_loop():
    got, want = _lm_pair()
    assert got["optimal_loss"] == want["optimal_loss"] == float(np.log(4))


@pytest.fixture(scope="module")
def lm_pack(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("lm_pack"))
    pack.main([out, "--synthetic-lm", "--vocab", "256", "--seq", "64",
               "--n", "64", "--shard-size", "16"])
    return out


def test_train_lm_from_a_pack_with_prefetch_matches_the_jax_loop(lm_pack):
    got, want = _lm_pair(data_dir=lm_pack, prefetch=2)
    assert got["optimal_loss"] == want["optimal_loss"]
    assert got["input_stall_s_per_step"] >= 0
    assert 0 <= got["prefetch_depth_avg"] <= 2


def test_train_lm_vocab_mismatch_raises_the_jax_message(lm_pack):
    jcfg, tcfg = _lm_configs()
    jcfg, tcfg = (dataclasses.replace(c, vocab_size=512) for c in (jcfg, tcfg))
    with pytest.raises(ValueError) as jerr:
        jcommon.train_lm(jopt.sngm(jpoly(0.1, 2)), jcfg, 16, 64, 2,
                         data_dir=lm_pack)
    with pytest.raises(ValueError) as terr:
        train_lm(topt.sngm(tpoly(0.1, 2)), tcfg, 16, 64, 2, device="cpu",
                 data_dir=lm_pack)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is present")
def test_loops_default_to_the_card_and_raise_without_one(images):
    _, (tx, ty, txt, tyt) = images
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_convnet(topt.sngm(tpoly(0.1, 2)), tx, ty, txt, tyt, 16, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lm(topt.sngm(tpoly(0.1, 2)), _lm_configs()[1], 4, 16, 1)


def test_ambient_tracker_context():
    assert isinstance(current_tracker(), NullTracker)
    mem = MemoryTracker()
    with with_tracker(mem):
        assert current_tracker() is mem
        current_tracker().log(0, {"x": 1})
    assert isinstance(current_tracker(), NullTracker)
    assert mem.steps == [(0, {"x": 1})]
    glob = MemoryTracker()
    set_global_tracker(glob)
    try:
        assert current_tracker() is glob
        with with_tracker(mem):
            assert current_tracker() is mem
        assert current_tracker() is glob
    finally:
        set_global_tracker(None)
    assert isinstance(current_tracker(), NullTracker)


@pytest.mark.parametrize("kw", [{"examples_per_step": 64},
                                {"tokens_per_step": 1024},
                                {"examples_per_step": 8, "tokens_per_step": 512}])
def test_step_timer_rates_equal_the_jax_timer(kw):
    stamps = [10.0, 10.5, 10.75, 11.5]
    got, want = StepTimer(**kw), JaxStepTimer(**kw)
    for t, stamp in enumerate(stamps[1:]):
        m = {"_t_wall": stamp, "_t_loop_start": stamps[0]}
        assert got.on_step(t, dict(m)) == want.on_step(t, dict(m))
    assert got.on_end() == want.on_end()
    if "examples_per_step" in kw:
        assert got.on_end()["examples_per_s"] == kw["examples_per_step"] * 3 / 1.5


def test_step_timer_examples_per_s_through_the_runner():
    mem = MemoryTracker()
    runner = CallbackRunner(mem, [StepTimer(examples_per_step=32)])
    for t in range(3):
        runner.push(t, {"loss": 1.0})
    runner.close()
    assert all(m["examples_per_s"] > 0 for _, m in mem.steps)
    assert mem.summary["examples_per_s"] > 0 and "tokens_per_s" not in mem.summary
