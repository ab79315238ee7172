"""The paper's two training loops: the image classifier of Fig. 1 and
Table 2, and the LM of Table 3, with gradient accumulation (the paper's
large-batch mechanism, §5).  A port of the host loops in the JAX
package's ``benchmarks/common.py``, without JAX.

Both loops run on the unified ``TrainState`` path (``opt.init_state`` /
``opt.step_state``), so a resident optimizer (``fused="multi_tensor"``)
keeps its flat buffers as the single parameter owner, as in the
launcher.  The convnet loop accumulates each micro-batch's gradients as
the train step does (``training.step._grad_leaves``): on the resident
path straight into the engine's flat gradient buffers, so nothing is
packed per step.

Both log through ``repro_torch.tracker``: ``tracker=`` receives every
step record (loss, grad_norm, lr, wall clock, throughput); an internal
``MemoryTracker`` keeps the curve the returned dict summarizes.  Both
run on the card unless ``device="cpu"`` is passed, and raise without
one (``models.runtime.resolve_device``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.optim import Optimizer
from repro_torch.models.convnet import accuracy, ce_loss, init_convnet
from repro_torch.models.runtime import resolve_device
from repro_torch.tracker import CompositeTracker, MemoryTracker, NullTracker
from repro_torch.tracker.callbacks import CallbackRunner, StepTimer
from repro_torch.training.step import _grad_leaves, _mean_grads

__all__ = ["train_convnet", "train_lm"]


def _fan_out(tracker) -> tuple:
    """(fan, mem): the caller's tracker beside a MemoryTracker that keeps
    the whole curve."""
    mem = MemoryTracker()
    return CompositeTracker([mem, tracker if tracker is not None
                             else NullTracker()]), mem


def train_convnet(opt: Optimizer, x, y, xt, yt, batch: int, steps: int,
                  accum_micro: int = 128, seed: int = 0, log_every: int = 0,
                  tracker=None, ghost_batch: Optional[int] = None,
                  device=None):
    """Train the Fig-1 convnet at global batch ``batch``; a batch larger
    than ``accum_micro`` accumulates gradients over micro-batches, as the
    paper does.  ``ghost_batch`` turns on parameter-free ghost batch
    normalization with that virtual batch.  The datasets (NHWC images,
    int labels; tensors or arrays) move to the device once; each step
    draws its indices from ``np.random.RandomState(seed)``."""
    dev = resolve_device(device)
    ts = opt.init_state(init_convnet(seed, device=dev))
    x, y, xt, yt = (torch.as_tensor(a).to(dev) for a in (x, y, xt, yt))
    n = x.shape[0]
    micro = min(batch, accum_micro)
    n_micro = batch // micro
    fan, mem = _fan_out(tracker)
    runner = CallbackRunner(fan, [StepTimer(examples_per_step=batch)],
                            flush_every=log_every or 50)
    rng = np.random.RandomState(seed)
    last_loss = np.inf
    for t in range(steps):
        idx = torch.from_numpy(rng.randint(0, n, size=(batch,))).to(dev)
        params, flat = _grad_leaves(ts)
        l_sum = 0.0
        for m in range(n_micro):
            sl = idx[m * micro:(m + 1) * micro]
            loss = ce_loss(params, x[sl], y[sl], ghost_batch=ghost_batch)
            loss.backward()
            l_sum += float(loss.detach())
        grads = _mean_grads(params, flat, n_micro)
        del params
        ts, stats = opt.step_state(grads, ts)
        last_loss = l_sum / n_micro
        runner.push(t, {"loss": last_loss, **stats})
        if log_every and (t + 1) % log_every == 0:
            print(f"    step {t+1}: loss={last_loss:.4f} "
                  f"gnorm={float(stats['grad_norm']):.3f}")
        if not np.isfinite(last_loss):
            break
    diverged = not np.isfinite(last_loss)
    with torch.no_grad():
        acc = 0.0 if diverged else float(
            accuracy(ts.params_view, xt, yt, ghost_batch=ghost_batch))
    runner.close({"final_loss": last_loss, "test_acc": acc,
                  "diverged": diverged})
    return {"final_loss": last_loss, "test_acc": acc,
            "losses": mem.series("loss"), "diverged": diverged,
            "wall_time_s": mem.summary.get("wall_time_s", 0.0),
            "examples_per_s": mem.summary.get("examples_per_s", 0.0)}


def train_lm(opt: Optimizer, cfg, batch: int, seq: int, steps: int,
             n_micro: int = 1, seed: int = 0, tracker=None,
             log_every: int = 0, device=None,
             data_dir: Optional[str] = None, prefetch: int = 0):
    """Train an LM config on the synthetic bigram language for ``steps``
    steps of global batch ``batch`` (the Table-3 equal-C loop), through
    ``make_train_step`` and ``run_steps``.

    ``data_dir`` reads a ``repro-data-pack`` dataset through the
    ``StreamingLoader`` in place of ``SyntheticLM.batch_at``;
    ``prefetch`` > 0 stages batches that deep ahead on the device
    (``PrefetchIterator``) and adds the input-stall counters to the
    result."""
    from repro_torch import prng
    from repro_torch.data import (DiskShardedSource, PrefetchIterator,
                                  StreamingLoader, SyntheticLM)
    from repro_torch.data.prefetch import HostToDevice
    from repro_torch.models import make_runtime, materialize, model_defs
    from repro_torch.tracker.callbacks import PrefetchMonitor
    from repro_torch.training.step import make_train_step, run_steps

    rt = make_runtime(device)
    params = materialize(model_defs(cfg), prng.PRNGKey(seed), rt.device)
    state = opt.init_state(params)
    del params
    step = make_train_step(cfg, rt, opt, n_micro=n_micro)
    callbacks = [StepTimer(tokens_per_step=batch * seq)]
    loader = prefetcher = None
    if data_dir:
        source = DiskShardedSource(data_dir)
        v = source.meta.get("vocab_size")
        if v is not None and v != cfg.vocab_size:
            raise ValueError(f"dataset {data_dir!r} vocab_size {v} != "
                             f"model vocab {cfg.vocab_size}")
        loader = StreamingLoader(source, batch, seed=seed)
        place = HostToDevice(rt.device, slots=max(prefetch, 0) + 2)
        if prefetch > 0:
            prefetcher = PrefetchIterator(loader, depth=prefetch, place=place)
            batches = prefetcher
            callbacks.append(PrefetchMonitor(prefetcher))
        else:
            batches = (place(b).wait() for b in loader)
        optimal = float(source.meta.get("optimal_loss", float("nan")))
    else:
        data = SyntheticLM(cfg.vocab_size, seq, batch, branching=4,
                           device=rt.device)
        batches = data.batch_at
        optimal = float(data.optimal_loss())
    fan, mem = _fan_out(tracker)
    try:
        run_steps(step, state, batches, steps, tracker=fan,
                  log_every=log_every or 50, callbacks=callbacks)
    finally:
        if prefetcher is not None:
            prefetcher.close()
        elif loader is not None:
            loader.close()
    losses = mem.series("loss")
    out = {"losses": losses, "final_loss": losses[-1],
           "optimal_loss": optimal,
           "wall_time_s": mem.summary.get("wall_time_s", 0.0),
           "tokens_per_s": mem.summary.get("tokens_per_s", 0.0)}
    if prefetcher is not None:
        out["input_stall_s_per_step"] = mem.summary.get(
            "input_stall_s_per_step", 0.0)
        out["prefetch_depth_avg"] = mem.summary.get("prefetch_depth_avg", 0.0)
    return out
