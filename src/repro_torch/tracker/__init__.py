"""repro_torch.tracker — step-scoped metrics backends.

The part of ``repro.tracker`` that the training loop and the launcher
use: one interface, several backends, fed host scalars.

    tracker.log(step, {"loss": 2.31, "grad_norm": 4.2})
    tracker.log_summary({"final_loss": 0.12})
    tracker.finish()

  * ``JsonlTracker``     — one JSON object per line (``read_jsonl``
                           reads the stream back);
  * ``StdoutTracker``    — progress lines, at most one per ``every`` steps;
  * ``MemoryTracker``    — in-memory (step, metrics) list, for tests and
                           for callers that read a curve back;
  * ``CompositeTracker`` — fan-out to several backends, in order;
  * ``NullTracker``      — the default no-op.

``current_tracker`` / ``set_global_tracker`` / ``with_tracker`` keep an
ambient tracker, so nested loops can log without a tracker argument
threaded through every call; explicit arguments still win where they
exist.

Values may be 0-dim torch tensors on any device: every backend coerces
through ``scalarize`` at log time (``tracker.callbacks.MetricsBuffer``
defers that device sync to the logging boundary).
"""
from __future__ import annotations

import json
import os
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = ["Tracker", "NullTracker", "MemoryTracker", "StdoutTracker",
           "JsonlTracker", "CompositeTracker", "scalarize", "read_jsonl",
           "current_tracker", "set_global_tracker", "with_tracker"]


def scalarize(value: Any) -> Any:
    """Coerce a metric value to a plain JSON-serializable Python scalar:
    numbers, strings, bools, None, 0-dim tensors or arrays (``.item()``);
    lists, tuples and dicts elementwise.  Non-scalar arrays are
    rejected: per-step metrics are scalars by contract."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, dict):
        return {k: scalarize(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [scalarize(v) for v in value]
    if hasattr(value, "ndim") and getattr(value, "ndim") != 0:
        raise TypeError(f"metric value must be a scalar, got array with "
                        f"shape {tuple(getattr(value, 'shape', ()))}")
    if hasattr(value, "item"):
        return value.item()
    raise TypeError(f"unsupported metric value type {type(value).__name__}")


class Tracker:
    """Metrics backend interface: ``log`` is step-scoped, ``log_summary``
    records run-level results, ``finish`` flushes and closes."""

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        self._log(int(step), {k: scalarize(v) for k, v in metrics.items()})

    def log_summary(self, metrics: Dict[str, Any]) -> None:
        self._log_summary({k: scalarize(v) for k, v in metrics.items()})

    def finish(self) -> None:  # idempotent
        pass

    def _log(self, step: int, metrics: Dict[str, Any]) -> None:
        raise NotImplementedError

    def _log_summary(self, metrics: Dict[str, Any]) -> None:
        raise NotImplementedError


class NullTracker(Tracker):
    def _log(self, step, metrics):
        pass

    def _log_summary(self, metrics):
        pass


class MemoryTracker(Tracker):
    """Records everything in memory (``.series("loss")`` reads a curve)."""

    def __init__(self) -> None:
        self.steps: List[Tuple[int, Dict[str, Any]]] = []
        self.summary: Dict[str, Any] = {}
        self.finished = False

    def _log(self, step, metrics):
        self.steps.append((step, metrics))

    def _log_summary(self, metrics):
        self.summary.update(metrics)

    def finish(self):
        self.finished = True

    def series(self, key: str) -> List[Any]:
        return [m[key] for _, m in self.steps if key in m]


def _body(metrics) -> str:
    return " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in metrics.items())


class StdoutTracker(Tracker):
    """Progress lines on stdout, at most one per ``every`` steps (summary
    always prints).  ``fmt(step, metrics) -> str`` overrides the line."""

    def __init__(self, every: int = 1, prefix: str = "", fmt=None) -> None:
        self.every = max(1, every)
        self.prefix = prefix
        self.fmt = fmt

    def _log(self, step, metrics):
        if step % self.every == 0:
            print(self.fmt(step, metrics) if self.fmt else
                  f"{self.prefix}step {step:5d} {_body(metrics)}", flush=True)

    def _log_summary(self, metrics):
        print(f"{self.prefix}summary {_body(metrics)}", flush=True)


class JsonlTracker(Tracker):
    """One JSON object per line: ``{"step": t, ...}`` for step records,
    ``{"summary": true, ...}`` for run-level ones; append mode."""

    def __init__(self, path: str) -> None:
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a")

    def _write(self, obj: Dict[str, Any]) -> None:
        if self._f is None:
            raise ValueError(f"JsonlTracker({self.path!r}) already finished")
        self._f.write(json.dumps(obj, sort_keys=True) + "\n")
        self._f.flush()

    def _log(self, step, metrics):
        self._write({"step": step, **metrics})

    def _log_summary(self, metrics):
        self._write({"summary": True, **metrics})

    def finish(self):
        if self._f is not None:
            self._f.close()
            self._f = None


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Parse a JsonlTracker stream back into its records, in order."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


class CompositeTracker(Tracker):
    """Fan out to several backends, in the order given."""

    def __init__(self, trackers) -> None:
        self.trackers = list(trackers)

    def _log(self, step, metrics):
        for t in self.trackers:
            t._log(step, metrics)

    def _log_summary(self, metrics):
        for t in self.trackers:
            t._log_summary(metrics)

    def finish(self):
        for t in self.trackers:
            t.finish()


# the ambient tracker: the innermost ``with_tracker`` block's, else the
# global one (a NullTracker until ``set_global_tracker``)
_GLOBAL: List[Tracker] = [NullTracker()]


def current_tracker() -> Tracker:
    return _GLOBAL[-1]


def set_global_tracker(tracker: Optional[Tracker]) -> None:
    _GLOBAL[0] = tracker if tracker is not None else NullTracker()


@contextmanager
def with_tracker(tracker: Tracker) -> Iterator[Tracker]:
    _GLOBAL.append(tracker)
    try:
        yield tracker
    finally:
        _GLOBAL.pop()
