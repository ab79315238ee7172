"""``repro_torch.data.prefetch`` and the launcher's data stream, against
the port's own ``StreamingLoader`` (which ``tests/test_torch_data.py``
holds against the JAX package).  This file imports no JAX, so its
``cuda`` test runs on a machine with the card and the port alone.

Held on the CPU:

  * ``PrefetchIterator(place=None)``: every batch bitwise the loader's,
    and ``state`` after each exactly the loader's cursor after that
    batch, whatever the worker has read ahead;
  * the failure, close and no-hang semantics of the JAX package's
    prefetcher (``tests/test_data_pipeline.py``): a source error
    surfaces exactly once, through ``next()`` or ``close()``; ``next()``
    after ``close()`` stops promptly; ``close()`` joins the worker;
  * the counters and ``PrefetchMonitor``'s per-step pairing;
  * ``device_put_batch`` on the CPU makes no CUDA call;
  * the launcher's ``PackStream``: the cursor it reports (and a
    checkpoint saves) is the prefetcher's, not the loader's run-ahead
    position, and after a ``train`` call the loader is left there.

On the card (``cuda`` marker): the pinned, side-stream placement.
"""
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import (MemorySource, PrefetchIterator, StreamingLoader,
                              device_put_batch, pack_dataset)
from repro_torch.data import prefetch as prefetch_mod
from repro_torch.launch import train as launcher
from repro_torch.tracker.callbacks import PrefetchMonitor


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _arrays(n, seq=8, seed=0):
    rng = np.random.RandomState(seed)
    return {"tokens": torch.from_numpy(
                rng.randint(0, 100, size=(n, seq)).astype(np.int32)),
            "loss_mask": torch.ones((n, seq), dtype=torch.float32)}


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _loader(n=48, **kw):
    return StreamingLoader(MemorySource(_arrays(n), shard_size=8), 8,
                           seed=5, **kw)


def _wait_full(pf, timeout=30.0):
    """Until the worker has filled the queue (it then runs ahead of the
    consumer by ``depth`` batches)."""
    t0 = time.perf_counter()
    while pf._q.qsize() < pf.depth:
        assert time.perf_counter() - t0 < timeout, "worker never filled the queue"
        time.sleep(0.01)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetch_batches_and_states_are_the_loaders(depth):
    sync = _loader()
    want = []
    for _ in range(9):                 # crosses an epoch (6 batches each)
        want.append((next(sync), sync.state))
    with PrefetchIterator(_loader(), depth=depth, place=None) as pf:
        assert pf.state == _loader().state
        for t, (batch, state) in enumerate(want):
            _wait_full(pf)
            _same(next(pf), batch)
            assert pf.state == state   # run-ahead does not leak into it
            assert pf._it.state != state
        c = pf.counters()
    assert not pf._thread.is_alive()
    assert c["prefetch_batches"] == 9 and c["prefetch_depth"] == depth
    assert c["prefetch_depth_avg"] == depth   # full at every next()
    assert len(pf.stall_log) == 9


def test_monitor_pairs_each_step_with_its_batch():
    pf = PrefetchIterator(_loader(), depth=2, place=None)
    mon = PrefetchMonitor(pf)
    for _ in range(3):
        next(pf)
    log = list(pf.stall_log)
    recs = [mon.on_step(t, {}) for t in range(3)]
    assert [(r["input_stall_s"], r["prefetch_depth"]) for r in recs] == log
    assert mon.on_step(3, {}) is None
    end = mon.on_end()
    assert end["input_stall_s"] == pytest.approx(sum(s for s, _ in log))
    assert end["prefetch_depth_avg"] == sum(d for _, d in log) / 3
    pf.close()


def test_exhaustion_and_max_epochs():
    with PrefetchIterator(_loader(max_epochs=1), depth=2, place=None) as pf:
        got = list(pf)
    assert len(got) == 6
    with pytest.raises(StopIteration):
        next(pf)


def test_depth_is_checked():
    with pytest.raises(ValueError, match="prefetch depth must be >= 1, got 0"):
        PrefetchIterator(_loader(), depth=0, place=None)


class _Exploding:
    """A source whose reads past example ``after`` raise."""

    def __init__(self, after=0):
        self.after = after

    def shard_lengths(self):
        return (16,)

    def read(self, shard, start, count):
        if start >= self.after:
            raise RuntimeError("disk on fire")
        return {k: v[:count] for k, v in _arrays(16).items()}


def _failing(after=0):
    return PrefetchIterator(StreamingLoader(_Exploding(after), 4, shuffle=False),
                            depth=2, place=None)


def test_source_errors_reach_the_consumer_after_the_good_batches():
    pf = _failing(after=8)
    assert len([next(pf) for _ in range(2)]) == 2
    with pytest.raises(RuntimeError, match="disk on fire"):
        for _ in range(4):
            next(pf)
    pf.close()                          # delivered already: no second raise


def test_close_surfaces_an_undelivered_failure_exactly_once():
    pf = _failing()
    pf._thread.join(timeout=10)         # the worker parks the failure and dies
    assert not pf._thread.is_alive()
    with pytest.raises(RuntimeError, match="disk on fire"):
        pf.close()
    pf.close()                          # idempotent: no second raise
    with pytest.raises(StopIteration):  # and no hang on the dead queue
        next(pf)


def test_next_never_hangs_after_close():
    pf = PrefetchIterator(_loader(32), depth=2, place=None)
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()
    done = threading.Event()

    def consume():
        with pytest.raises(StopIteration):
            next(pf)
        done.set()
    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=30)
    assert done.is_set()
    pf.close()


def test_close_refuses_to_leave_a_stuck_worker(monkeypatch):
    """A worker still inside a read at the join deadline is reported, not
    left to run at interpreter exit."""
    release = threading.Event()

    class Slow(_Exploding):
        def read(self, shard, start, count):
            release.wait(30)
            return {k: v[:count] for k, v in _arrays(16).items()}

    monkeypatch.setattr(prefetch_mod, "JOIN_TIMEOUT_S", 0.2)
    pf = PrefetchIterator(StreamingLoader(Slow(), 4, shuffle=False), depth=2,
                          place=None)
    try:
        with pytest.raises(RuntimeError, match="still running"):
            pf.close()
    finally:
        release.set()
        pf._thread.join(timeout=30)
    assert not pf._thread.is_alive()


def test_cpu_placement_makes_no_cuda_call(monkeypatch):
    def no_cuda(*a, **k):
        raise AssertionError("a CUDA call on the CPU path")
    for name in ("Stream", "Event", "current_stream", "stream", "device"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    monkeypatch.setattr(torch.Tensor, "pin_memory", no_cuda)
    monkeypatch.setattr(torch.Tensor, "record_stream", no_cuda)
    sync = _loader()
    with PrefetchIterator(_loader(), depth=2,
                          place=lambda b: device_put_batch(b, "cpu")) as pf:
        for _ in range(4):
            _same(next(pf), next(sync))
    staged = device_put_batch(_arrays(2), torch.device("cpu"))
    assert staged.event is None
    _same(staged.wait(), _arrays(2))


# ------------------------------------------------ the launcher's stream

def _pack(tmp_path, n=48):
    path = str(tmp_path / "ds")
    pack_dataset(path, _arrays(n), shard_size=8,
                 meta={"vocab_size": 100, "seq_len": 8})
    return path


def _stream(tmp_path, prefetch, seed=5):
    args = SimpleNamespace(data_dir=_pack(tmp_path), seq=99, batch=8,
                           seed=seed, prefetch=prefetch)
    cfg = SimpleNamespace(vocab_size=100, name="test")
    return launcher.PackStream(args, cfg, torch.device("cpu"))


@pytest.mark.parametrize("prefetch", [0, 2])
def test_the_saved_cursor_is_the_next_batch_training_consumes(prefetch, tmp_path):
    """What a checkpoint saves (``Run.loader_state``) after t batches is
    the host loader's cursor after t batches, while the prefetch worker
    has read further ahead; after the stream stops the loader is back at
    that cursor, and the next batches follow on."""
    stream = _stream(tmp_path, prefetch)
    assert stream.seq == 8
    run = SimpleNamespace(data=stream)
    ref = _loader()
    it = stream.start()
    for t in range(5):
        _same(next(it), next(ref))
        if prefetch:
            _wait_full(stream.prefetcher)
            assert stream.loader.state != ref.state    # it has run ahead
        assert launcher.Run.loader_state(run) == ref.state
    stream.stop()
    assert stream.prefetcher is None
    assert stream.loader.state == ref.state
    it = stream.start()
    _same(next(it), next(ref))
    stream.close()


def test_a_vocab_mismatch_stops_the_launcher(tmp_path):
    args = SimpleNamespace(data_dir=_pack(tmp_path), seq=8, batch=8, seed=0,
                           prefetch=2)
    cfg = SimpleNamespace(vocab_size=256, name="toy")
    with pytest.raises(SystemExit, match="vocab_size 100 != model vocab 256"):
        launcher.PackStream(args, cfg, torch.device("cpu"))


# ------------------------------------------------------------- the card

@pytest.mark.cuda
def test_cuda_staged_placement_matches_the_host_batches():
    """Pinned, non-blocking, on a side stream, waited for on the
    consumer's stream: every batch the loader's, bitwise, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    host = _arrays(8)
    staged = device_put_batch(host)
    assert staged.event is not None
    assert staged.device.type == "cuda"
    got = staged.wait()
    for k, v in got.items():
        assert v.is_cuda
        assert torch.equal(v.cpu(), host[k])
    sync = _loader()
    with PrefetchIterator(_loader(), depth=2) as pf:
        for _ in range(9):
            b = next(pf)
            for k, v in next(sync).items():
                assert torch.equal(b[k].cpu(), v), k
    torch.cuda.synchronize()
