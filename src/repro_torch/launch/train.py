"""Training launcher: SNGM (or a baseline) on a decoder LM.

A port of ``repro.launch.train`` with its flags and defaults and the
same stdout line format, so the two launchers' logs diff line by line.
It adds:

  * ``--device``: ``cuda`` (the default) or ``cpu``.  Without a card it
    raises unless ``--device cpu`` is given.
  * ``--seed``: the weights are ``materialize(defs, PRNGKey(seed))`` and
    the batches ``SyntheticLM(..., seed=seed)``, drawn as the JAX package
    draws them (``repro_torch.prng``); at ``--seed 0`` they are the JAX
    launcher's (it always uses seed 0), so the two launchers' lines
    can be diffed.

Every optimizer of the JAX launcher runs (sngm, sngd, msgd, lars,
lamb), in each execution mode it offers: ``--fused none``,
``multi_tensor`` (all five) and ``per_leaf`` (sngm, sngd, lars).  Not
ported yet, and refused with a clear error: checkpoints (``--ckpt``,
``--resume``), ``--data-dir``, ``--ema-decay`` and meshes
(``--model-axis``, ``--pod-axis``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --reduced --device cpu --steps 4 --batch 4 --seq 32 \\
        --optimizer sngm --fused multi_tensor --log-every 1
"""
from __future__ import annotations

import argparse
import dataclasses
import inspect
from typing import Any, List, Optional, Sequence

import torch

from repro_torch import prng
from repro_torch.configs import ARCHS, get_config, smoke_variant
from repro_torch.core.optim import (OPTIMIZERS, TrainState, make_optimizer,
                                    optimizer_names)
from repro_torch.data import SyntheticLM
from repro_torch.models import count, make_runtime, materialize, model_defs
from repro_torch.tracker import (CompositeTracker, JsonlTracker, MemoryTracker,
                                 StdoutTracker)
from repro_torch.tracker.callbacks import StepTimer
from repro_torch.training import make_train_step, run_steps

NOT_PORTED = "is not ported yet (ROADMAP.md Queue A)"


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale variant (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-micro", type=int, default=2)
    ap.add_argument("--optimizer", default="sngm",
                    choices=list(optimizer_names()))
    ap.add_argument("--fused", default="none",
                    choices=["none", "per_leaf", "multi_tensor"],
                    help="optimizer execution path: plain PyTorch (none), "
                         "one CUDA kernel per tensor (per_leaf: sngm, sngd, "
                         "lars), or the dtype-bucketed multi-tensor engine "
                         "with its CUDA kernels (multi_tensor; 2 launches "
                         "per step for sngm and lamb)")
    ap.add_argument("--lr", type=float, default=1.6)
    ap.add_argument("--beta", type=float, default=0.9)
    ap.add_argument("--weight-decay", type=float, default=1e-4)
    ap.add_argument("--nesterov", action="store_true",
                    help="look-ahead momentum (sngm, msgd); fused into the "
                         "update pass, so the launch count is unchanged")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-jsonl", default="",
                    help="append per-step metrics (loss, grad_norm, lr, "
                         "wall-clock, tokens/sec) as JSON lines to this path")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    # accepted so that the JAX launcher's command lines give a clear error
    ap.add_argument("--ema-decay", type=float, default=0.0)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--data-dir", default="")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--pod-axis", type=int, default=1)
    args = ap.parse_args(argv)
    for flag, on in (("--ema-decay", args.ema_decay != 0.0),
                     ("--ckpt / --resume", bool(args.ckpt) or args.resume),
                     ("--data-dir", bool(args.data_dir)),
                     ("a mesh (--model-axis, --pod-axis)",
                      args.model_axis != 1 or args.pod_axis != 1)):
        if on:
            ap.error(f"{flag} {NOT_PORTED}")
    return args


@dataclasses.dataclass
class Run:
    """What ``build`` sets up: the step function, the state, the data."""
    cfg: Any
    opt: Any
    state: TrainState
    step: Any
    data: SyntheticLM
    n_params: int


def build(args) -> Run:
    """Config, runtime, random weights, optimizer, train step and data,
    as the launcher builds them."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = smoke_variant(cfg)
    rt = make_runtime(args.device, remat=not args.reduced)
    defs = model_defs(cfg)
    params = materialize(defs, prng.PRNGKey(args.seed), rt.device)
    fused = None if args.fused == "none" else args.fused
    schedule = {"name": "poly_power",
                "kwargs": {"lr0": args.lr, "total_steps": args.steps,
                           "power": 1.1}}
    # each optimizer takes the flags its builder accepts, as in the JAX
    # launcher (sngd and lamb have no beta; only sngm and msgd take nesterov)
    accepts = inspect.signature(OPTIMIZERS[args.optimizer]).parameters
    kw = {k: v for k, v in (("beta", args.beta),
                            ("weight_decay", args.weight_decay),
                            ("nesterov", args.nesterov), ("fused", fused))
          if k in accepts}
    opt = make_optimizer(args.optimizer, schedule, **kw)
    state = opt.init_state(params)
    del params
    step = make_train_step(cfg, rt, opt, n_micro=args.n_micro)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed,
                       branching=4, device=rt.device)
    return Run(cfg, opt, state, step, data, count(defs))


def fmt(t, m):
    return (f"  step {t:5d} loss={m['loss']:.4f} "
            f"||g||={m.get('grad_norm', float('nan')):.3f} "
            f"lr={m.get('lr', float('nan')):.4f} "
            f"({m.get('it_per_s', 0.0):.2f} it/s)")


def train(args, run: Run):
    """Run ``args.steps`` steps; returns (final state, MemoryTracker)."""
    mem = MemoryTracker()
    backends = [mem, StdoutTracker(every=args.log_every, fmt=fmt)]
    if args.metrics_jsonl:
        backends.append(JsonlTracker(args.metrics_jsonl))
    state = run_steps(run.step, run.state, run.data.batch_at, args.steps,
                      tracker=CompositeTracker(backends),
                      log_every=args.log_every,
                      callbacks=[StepTimer(tokens_per_step=args.batch * args.seq)])
    return state, mem


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    args = parse_args(argv)
    run = build(args)
    print(f"[train] {run.cfg.name}: {run.n_params:,} params on 1 device(s) "
          f"across 1 process(es)")
    _, mem = train(args, run)
    return mem.series("loss")


if __name__ == "__main__":
    main()
