"""Callback layer over the tracker: buffered per-step logging plus
derived metrics (wall clock, throughput, input-pipeline health).  The
part of ``repro.tracker.callbacks`` the training loop uses.

The train step leaves its stats as 0-dim tensors on the device; reading
them every step would wait for the device.  ``MetricsBuffer`` keeps them
and converts at flush boundaries, stamping each step with its host time
at push time.  ``CallbackRunner`` drives it:

    push(step, stats)     # no sync
    flush():  for each buffered step, in order: scalarize, let every
              callback add its metrics (registration order), log
    close():  flush, merge the callbacks' summaries, log it, finish
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.tracker import NullTracker, Tracker, scalarize

__all__ = ["Callback", "StepTimer", "PrefetchMonitor", "MetricsBuffer",
           "CallbackRunner"]


class Callback:
    """``on_step`` may return metrics to merge into the step's record;
    ``on_end`` may return run-level summary metrics."""

    def on_step(self, step: int,
                metrics: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        return None

    def on_end(self) -> Optional[Dict[str, Any]]:
        return None


class StepTimer(Callback):
    """``step_time_s`` (host time between pushes: it includes dispatch,
    not the device's work that the flush waits for), ``it_per_s``
    (cumulative) and, when known, ``tokens_per_s`` / ``examples_per_s``.
    The first step counts from the loop start, so set-up shows up in
    step 0."""

    def __init__(self, tokens_per_step: Optional[int] = None,
                 examples_per_step: Optional[int] = None) -> None:
        self.tokens_per_step = tokens_per_step
        self.examples_per_step = examples_per_step
        self.t_start: Optional[float] = None
        self.t_prev: Optional[float] = None
        self.n_steps = 0

    def _rates(self, steps: int, seconds: float) -> Dict[str, float]:
        out = {}
        if self.tokens_per_step:
            out["tokens_per_s"] = self.tokens_per_step * steps / seconds
        if self.examples_per_step:
            out["examples_per_s"] = self.examples_per_step * steps / seconds
        return out

    def on_step(self, step, metrics):
        t_wall = metrics.get("_t_wall", time.perf_counter())
        if self.t_start is None:
            self.t_start = metrics.get("_t_loop_start", t_wall)
            self.t_prev = self.t_start
        dt = max(t_wall - self.t_prev, 1e-9)
        self.t_prev = t_wall
        self.n_steps += 1
        elapsed = max(t_wall - self.t_start, 1e-9)
        return {"step_time_s": dt, "it_per_s": self.n_steps / elapsed,
                **self._rates(1, dt)}

    def on_end(self):
        if self.t_start is None:
            return None
        elapsed = max((self.t_prev or self.t_start) - self.t_start, 1e-9)
        return {"wall_time_s": elapsed, "it_per_s": self.n_steps / elapsed,
                **self._rates(self.n_steps, elapsed)}


class PrefetchMonitor(Callback):
    """Input-pipeline health metrics from a
    ``repro_torch.data.PrefetchIterator`` (or anything exposing its
    ``stall_log``/``counters()`` surface).

    Per step: ``input_stall_s`` (time the step blocked waiting for a
    batch) and ``prefetch_depth`` (queue occupancy when the batch was
    taken).  The prefetcher appends one ``stall_log`` entry per consumed
    batch in order, and the runner flushes records in step order, so
    popping left keeps the pairing exact even though flushes are
    deferred.  ``on_end``: run-level ``input_stall_s`` total,
    ``input_stall_s_per_step`` and ``prefetch_depth_avg``."""

    def __init__(self, prefetcher) -> None:
        self.prefetcher = prefetcher

    def on_step(self, step, metrics):
        log = getattr(self.prefetcher, "stall_log", None)
        if not log:
            return None
        stall, depth = log.popleft()
        return {"input_stall_s": stall, "prefetch_depth": depth}

    def on_end(self):
        c = self.prefetcher.counters()
        return {"input_stall_s": c["input_stall_s"],
                "input_stall_s_per_step": c["input_stall_s_per_step"],
                "prefetch_depth_avg": c["prefetch_depth_avg"]}


class MetricsBuffer:
    """``push`` stores the raw stats plus a host time stamp; ``drain``
    converts them (one device wait) and yields them in step order."""

    def __init__(self) -> None:
        self._buf: List[Tuple[int, Dict[str, Any], float]] = []
        self.t_loop_start = time.perf_counter()

    def push(self, step: int, stats: Dict[str, Any]) -> None:
        self._buf.append((step, stats, time.perf_counter()))

    def drain(self) -> List[Tuple[int, Dict[str, Any]]]:
        out = []
        for step, stats, t_wall in self._buf:
            rec = {k: scalarize(v) for k, v in stats.items()}
            rec["_t_wall"] = t_wall
            out.append((step, rec))
        self._buf.clear()
        return out


class CallbackRunner:
    """Buffered tracker pump: push stats each step, flush every
    ``flush_every`` steps, close at loop end.  The ``_t_wall`` /
    ``_t_loop_start`` stamps feed the timing callbacks and are stripped
    before a record reaches the tracker."""

    def __init__(self, tracker: Optional[Tracker] = None,
                 callbacks: Sequence[Callback] = (),
                 flush_every: int = 1) -> None:
        self.tracker = tracker if tracker is not None else NullTracker()
        self.callbacks = list(callbacks)
        self.flush_every = max(1, flush_every)
        self._buffer = MetricsBuffer()
        self._first = True
        self._n_pushed = 0
        self._closed = False

    def push(self, step: int, stats: Dict[str, Any]) -> None:
        if self._closed:
            raise RuntimeError("CallbackRunner already closed")
        self._buffer.push(step, stats)
        self._n_pushed += 1
        if self._n_pushed % self.flush_every == 0:
            self.flush()

    def flush(self) -> None:
        for step, metrics in self._buffer.drain():
            if self._first:
                metrics["_t_loop_start"] = self._buffer.t_loop_start
                self._first = False
            for cb in self.callbacks:
                extra = cb.on_step(step, metrics)
                if extra:
                    metrics.update(extra)
            self.tracker.log(step, {k: v for k, v in metrics.items()
                                    if not k.startswith("_")})

    def close(self, summary: Optional[Dict[str, Any]] = None) -> None:
        if self._closed:
            return
        self.flush()
        merged: Dict[str, Any] = {}
        for cb in self.callbacks:
            extra = cb.on_end()
            if extra:
                merged.update(extra)
        if summary:
            merged.update(summary)
        if merged:
            self.tracker.log_summary(merged)
        self.tracker.finish()
        self._closed = True
