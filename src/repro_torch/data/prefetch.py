"""Background host-to-device prefetch.  A port of ``repro.data.prefetch``.

``PrefetchIterator`` wraps any host batch iterator (typically a
``StreamingLoader``) with a worker thread that stays ``depth`` batches
ahead: it pulls the next host batch, starts its copy to the card
(``place``, by default ``device_put_batch``) and parks it in a bounded
queue.  The consumer's ``next()`` then returns a batch whose copy was
queued ahead of time, so a train step waits on host I/O only when the
queue is empty; that blocked time is the **input stall** counter.

On the card the copy runs off the training stream (``HostToDevice``).
The worker copies the host batch into a ring of pinned buffers (one set
a slot, reused only after the event of the copy that last read it has
completed), copies that to the card with ``non_blocking=True`` on a side
stream of its own device, and records an event (``StagedBatch``).  The
consumer, on its own thread, makes its current stream wait on that
event and marks every tensor with ``record_stream``, so the caching
allocator does not give a block back to the side stream while the step
still reads it.  The current device and stream are per thread, so the
worker names its device explicitly.  ``place=None`` keeps the batches on
the host, and a CPU device makes no CUDA call at all.  Nothing falls
back: a failed pin, copy or event raises through ``next()``.

Checkpoint coupling: the worker snapshots ``loader.state`` immediately
after pulling each batch, and the snapshot travels WITH the batch
through the queue — so ``prefetch.state`` after training consumed batch
``t`` is the cursor of batch ``t+1`` even though the loader itself has
already run ahead.  Saving ``prefetch.state`` (not ``loader.state``!)
is what keeps resume exact under prefetch; the train launcher does
exactly that.

Default ``depth=2`` is classic double buffering: one batch in flight to
the device while the step consumes the previous one.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, Optional

import torch

__all__ = ["PrefetchIterator", "HostToDevice", "StagedBatch",
           "device_put_batch"]

JOIN_TIMEOUT_S = 30.0              # close(): a worker longer than this is stuck


class StagedBatch:
    """A batch whose host-to-device copy was queued on a side stream;
    ``event`` marks the copy's end (None: a CPU batch, nothing to wait
    for)."""

    def __init__(self, batch: Dict[str, torch.Tensor],
                 event: Optional[torch.cuda.Event] = None,
                 device: Optional[torch.device] = None):
        self.batch, self.event, self.device = batch, event, device

    def wait(self) -> Dict[str, torch.Tensor]:
        """The batch, for use on the calling thread's current stream:
        that stream waits for the copy, and each tensor is recorded as
        used there."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self.event)
            for v in self.batch.values():
                v.record_stream(stream)
        return self.batch


class HostToDevice:
    """Copies host batches (dicts of CPU tensors) to ``device`` (default:
    the current CUDA device): each field into a pinned buffer of a ring
    of ``slots``, then to the card with ``non_blocking=True`` on a side
    stream of the device's own, an event recorded after it.  A call
    returns a ``StagedBatch``; on a CPU device the batch itself, with no
    CUDA call.  One object per producer thread: the ring is not locked.
    """

    def __init__(self, device=None, slots: int = 4):
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"cannot place a batch on {self.device}")
        if slots < 1:
            raise ValueError(f"need at least one pinned slot, got {slots}")
        self.slots = slots
        self._stream: Optional[torch.cuda.Stream] = None
        self._ring: list = [None] * slots     # per slot: (buffers, event)
        self._next = 0

    def _pinned(self, slot: int, batch) -> Dict[str, torch.Tensor]:
        """The slot's pinned buffers, once the copy that last read them is
        done; (re)allocated when the batch's fields change."""
        held = self._ring[slot]
        if held is not None:
            bufs, event = held
            event.synchronize()
            if all(k in bufs and bufs[k].shape == v.shape and
                   bufs[k].dtype == v.dtype for k, v in batch.items()):
                return bufs
        return {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                for k, v in batch.items()}

    def __call__(self, batch: Dict[str, torch.Tensor]) -> StagedBatch:
        if self.device.type == "cpu":
            return StagedBatch({k: v.to(self.device) for k, v in batch.items()})
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        with torch.cuda.device(self.device):
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            slot = self._next
            self._next = (slot + 1) % self.slots
            bufs = self._pinned(slot, batch)
            out = {}
            with torch.cuda.stream(self._stream):
                for k, v in batch.items():
                    bufs[k].copy_(v)
                    out[k] = bufs[k].to(self.device, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
            self._ring[slot] = (bufs, event)
        return StagedBatch(out, event, self.device)


def device_put_batch(batch: Dict[str, torch.Tensor],
                     device=None) -> StagedBatch:
    """One batch's copy to ``device`` (default: the current CUDA device),
    staged as ``HostToDevice`` stages it; on a CPU device the batch
    itself, with no CUDA call.  As ``PrefetchIterator``'s default
    ``place`` it stands for a ``HostToDevice`` of the iterator's own
    (a side stream and ``depth + 2`` pinned slots, reused batch after
    batch)."""
    return HostToDevice(device, slots=1)(batch)


class _Stop:
    """Queue sentinel: clean exhaustion of the upstream iterator."""


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchIterator:
    """See module docstring.

    Counters (host wall-clock, cumulative — use ``counters()`` or the
    per-batch ``stall_log``):

      * ``input_stall_s`` — total time ``next()`` spent blocked waiting
        for the queue (the time a train step waited on input);
      * ``prefetch_depth_sum`` — queue occupancy observed at each
        ``next()``, for the average depth readout (a healthy pipeline
        sits near ``depth``; ~0 means the source can't keep up).

    ``place=None`` skips device placement (pure host-side prefetch);
    ``place=device_put_batch`` (default) starts each batch's copy to the
    current CUDA device in the worker thread, through a ``HostToDevice``
    with ``depth + 2`` pinned slots.  ``place`` may return a plain batch
    or a ``StagedBatch``, which ``next()`` waits for on the consumer's
    stream.
    """

    def __init__(self, it: Iterator[Dict[str, Any]], depth: int = 2,
                 place: Optional[Callable[[Any], Any]] = device_put_batch):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._it = it
        self.depth = depth
        self._place = (HostToDevice(slots=depth + 2) if place is device_put_batch
                       else place)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        # state snapshot accompanying the last batch next() yielded: the
        # cursor of the next UNCONSUMED batch (see module docstring)
        self._state = getattr(it, "state", None)
        self.input_stall_s = 0.0
        self.prefetch_depth_sum = 0
        self.n_batches = 0
        self.stall_log: deque = deque()   # (stall_s, depth) per batch
        self._exhausted = False
        self._closed = False
        # a worker _Failure that close() drained before next() saw it:
        # held so the error surfaces exactly once instead of vanishing
        self._pending_error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="repro-torch-prefetch")
        self._thread.start()

    # -- worker ---------------------------------------------------------
    def _worker(self) -> None:
        try:
            while not self._stop.is_set():
                try:
                    batch = next(self._it)
                except StopIteration:
                    self._put(_Stop())
                    return
                state = getattr(self._it, "state", None)
                if self._place is not None:
                    batch = self._place(batch)
                self._put((batch, state))
        except BaseException as e:  # propagate to the consumer
            self._put(_Failure(e))

    def _put(self, item) -> None:
        """Bounded put that aborts promptly when the consumer closes."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    # -- consumer -------------------------------------------------------
    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self):
        if self._exhausted:
            raise StopIteration
        depth_now = self._q.qsize()
        t0 = time.perf_counter()
        # poll rather than block indefinitely: a worker that died WITHOUT
        # parking a sentinel (crashed hard, or aborted its bounded put
        # when close() raced this next()) would otherwise hang the
        # consumer forever on an empty queue
        while True:
            try:
                item = self._q.get(timeout=0.05)
                break
            except queue.Empty:
                if self._stop.is_set():
                    self._exhausted = True
                    raise StopIteration from None
                if not self._thread.is_alive():
                    self._exhausted = True
                    if self._pending_error is not None:
                        err, self._pending_error = self._pending_error, None
                        raise err
                    raise StopIteration from None
        if isinstance(item, _Stop):
            self._exhausted = True
            raise StopIteration
        if isinstance(item, _Failure):
            self._exhausted = True
            raise item.exc
        batch, state = item
        if isinstance(batch, StagedBatch):
            batch = batch.wait()
        stall = time.perf_counter() - t0
        self._state = state
        self.input_stall_s += stall
        self.prefetch_depth_sum += depth_now
        self.n_batches += 1
        self.stall_log.append((stall, depth_now))
        return batch

    @property
    def state(self):
        """``LoaderState`` of the next unconsumed batch (exact under
        prefetch run-ahead); None when the upstream iterator carries no
        state."""
        return self._state

    def counters(self) -> Dict[str, float]:
        n = max(self.n_batches, 1)
        return {"input_stall_s": self.input_stall_s,
                "input_stall_s_per_step": self.input_stall_s / n,
                "prefetch_depth_avg": self.prefetch_depth_sum / n,
                "prefetch_depth": self.depth,
                "prefetch_batches": self.n_batches}

    def close(self) -> None:
        """Stop the worker and join it, release the upstream iterator, and
        surface an undelivered worker failure exactly once.  Idempotent —
        a second ``close()`` (or one after a failed worker) is a no-op;
        also runs on ``with`` exit.  A worker still alive after
        ``JOIN_TIMEOUT_S`` raises ``RuntimeError``: left running, it
        could sit inside a CUDA call at interpreter exit."""
        if self._closed:
            return
        self._closed = True
        self._exhausted = True
        self._stop.set()

        def drain():
            # discard buffered batches but KEEP an undelivered _Failure
            try:
                while True:
                    item = self._q.get_nowait()
                    if isinstance(item, _Failure) \
                            and self._pending_error is None:
                        self._pending_error = item.exc
            except queue.Empty:
                pass

        drain()                      # unblock a worker parked on a full queue
        self._thread.join(timeout=JOIN_TIMEOUT_S)
        drain()                      # the worker may have parked one more
        if self._thread.is_alive():
            raise RuntimeError(f"prefetch worker still running "
                               f"{JOIN_TIMEOUT_S:g} s after close()")
        close = getattr(self._it, "close", None)
        if close is not None:
            close()
        if self._pending_error is not None:
            err, self._pending_error = self._pending_error, None
            raise err

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *_) -> None:
        self.close()
