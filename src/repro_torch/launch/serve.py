"""Serving launcher: continuous batching on the paged engine.

A port of ``repro.launch.serve`` with the same flags and the same
``[serve:paged]`` report lines.  Only ``--engine paged`` is ported (the
dense ``ContinuousBatcher`` is still to port).  It adds:

  * ``--device``: ``cuda`` (the default) or ``cpu``.  Without a card it
    raises unless ``--device cpu`` is given.
  * ``--reduced``: serve the 2-layer ``smoke_variant`` of the arch.  The
    JAX launcher always serves the smoke variant; this one serves the
    full published widths unless ``--reduced`` is given.

Weights are random, ``materialize(defs, PRNGKey(--seed))`` drawn as the
JAX package draws them (no checkpoint is loaded); the JAX launcher
always draws them from ``PRNGKey(0)``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --slots 8 --requests 16 --prompt-len 128 --max-new 64
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs import ARCHS, get_config, smoke_variant
from repro_torch.configs.base import ModelConfig
from repro_torch.models import (cast_for_compute, count, make_runtime,
                                materialize, model_defs)
from repro_torch.models.runtime import Runtime
from repro_torch.serving.paged_cache import n_blocks_for
from repro_torch.serving.scheduler import PagedScheduler, ServeRequest


def load_model(cfg: ModelConfig, rt: Runtime, seed: int):
    """Random weights for ``cfg`` on ``rt.device``, matmul weights cast
    once to the compute dtype.  Returns (params, n_params)."""
    defs = model_defs(cfg)
    params = materialize(defs, prng.PRNGKey(seed), rt.device)
    return cast_for_compute(params, cfg), count(defs)


def build_scheduler(cfg: ModelConfig, params, rt: Runtime, *, slots: int,
                    block_size: int, blocks: int, ctx: int, decode_chunk: int,
                    temperature: float = 0.0, top_k: int = 0,
                    seed: int = 0) -> PagedScheduler:
    """The paged scheduler as the launcher builds it; ``blocks == 0``
    sizes the pool for every slot at full context."""
    n_blocks = blocks or (1 + slots * n_blocks_for(ctx, block_size))
    return PagedScheduler(cfg, params, rt, n_slots=slots,
                          block_size=block_size, n_blocks=n_blocks,
                          ctx_max=ctx, decode_chunk=decode_chunk,
                          temperature=temperature, top_k=top_k, seed=seed)


def serve(sched: PagedScheduler, prompts: Sequence[np.ndarray],
          max_new: int, per_round: int = 0) -> List[ServeRequest]:
    """Serve ``prompts`` and drain the scheduler; prints the launcher's
    ``[serve:paged]`` report.  ``per_round == 0`` submits every request
    at once (the launcher's traffic); ``per_round > 0`` lets that many
    arrive before each scheduler round, an open-loop arrival stream."""
    reqs = [ServeRequest(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    per_round = per_round or len(reqs)
    t0 = time.monotonic()
    nxt = 0
    while nxt < len(reqs) or not sched.idle:
        for req in reqs[nxt:nxt + per_round]:
            sched.submit(req)
        nxt += per_round
        sched.step()
    if sched.device.type == "cuda":
        torch.cuda.synchronize(sched.device)
    report(sched.finished, time.monotonic() - t0, sched.stats["decode_steps"],
           "paged")
    print(f"[serve:paged] peak blocks {sched.stats['peak_used_blocks']}"
          f"/{sched.alloc.n_blocks - 1}, preemptions "
          f"{sched.stats['preemptions']}, compiles {sched.compile_counts()}")
    return sched.finished


def report(finished, dt: float, steps: int, label: str):
    total_tokens = sum(len(r.out) for r in finished)
    lats = [r.t_done - r.t_submit for r in finished if r.t_done]
    print(f"[serve:{label}] {len(finished)} requests, {total_tokens} tokens, "
          f"{steps} decode steps, {total_tokens / dt:.1f} tok/s, {dt:.2f}s")
    if lats:
        print(f"[serve:{label}] request latency "
              f"p50 {np.percentile(lats, 50) * 1e3:.0f}ms "
              f"p99 {np.percentile(lats, 99) * 1e3:.0f}ms "
              f"mean {np.mean(lats) * 1e3:.0f}ms")


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b", choices=sorted(ARCHS))
    ap.add_argument("--engine", default="paged", choices=["paged"],
                    help="the dense engine is not ported yet")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy (reproducible); >0 samples")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--blocks", type=int, default=0,
                    help="KV pool blocks (0 = enough for all slots)")
    ap.add_argument("--decode-chunk", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--reduced", action="store_true",
                    help="serve the 2-layer smoke variant of the arch")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[ServeRequest]:
    args = parse_args(argv)
    rt = make_runtime(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = smoke_variant(cfg)
    params, n_params = load_model(cfg, rt, args.seed)
    print(f"[serve] {cfg.name}: {n_params:,} params on {rt.device}")
    ctx = args.prompt_len + args.max_new

    rng = np.random.RandomState(args.seed)
    prompts = [rng.randint(0, cfg.vocab_size, (args.prompt_len,))
               .astype(np.int32) for _ in range(args.requests)]
    sched = build_scheduler(cfg, params, rt, slots=args.slots,
                            block_size=args.block_size, blocks=args.blocks,
                            ctx=ctx, decode_chunk=args.decode_chunk,
                            temperature=args.temperature, top_k=args.top_k,
                            seed=args.seed)
    return serve(sched, prompts, args.max_new)


if __name__ == "__main__":
    main()
