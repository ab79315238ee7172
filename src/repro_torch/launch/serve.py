"""Serving launcher: continuous batching on either engine.

A port of ``repro.launch.serve`` with the same flags and the same
``[serve:paged]`` / ``[serve:dense]`` report lines:

  * ``--engine paged`` (default): ``serving.scheduler.PagedScheduler``,
    paged KV blocks, COW prefix sharing, bucket-padded batched prefill,
    chunked decode, preemption under memory pressure.
  * ``--engine dense``: the slot-spliced ``ContinuousBatcher`` baseline
    (an O(n_slots x ctx) dense cache, one prefill per request, one host
    sync per token).

It adds:

  * ``--device``: ``cuda`` (the default) or ``cpu``.  Without a card it
    raises unless ``--device cpu`` is given.
  * ``--reduced``: serve the 2-layer ``smoke_variant`` of the arch.  The
    JAX launcher always serves the smoke variant; this one serves the
    full published widths unless ``--reduced`` is given.

Both engines are decoder-only, as the JAX package's are (its launcher
fails on Whisper on both): an encoder-decoder is refused before any
weight is drawn, and serves through ``serving.engine.greedy_generate``
with its frame embeddings (ROADMAP.md Queue C).

Weights are random, ``materialize(defs, PRNGKey(--seed))`` drawn as the
JAX package draws them (no checkpoint is loaded); the JAX launcher
always draws them from ``PRNGKey(0)``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --slots 8 --requests 16 --prompt-len 128 --max-new 64 \\
        [--engine dense]
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs import ARCHS, get_config, smoke_variant
from repro_torch.configs.base import ModelConfig
from repro_torch.models import count, make_runtime, materialize, model_defs
from repro_torch.models.transformer import compute_cast
from repro_torch.models.runtime import Runtime
from repro_torch.serving.engine import (cache_batch_axes, make_prefill_step,
                                        make_serve_step, pad_cache,
                                        sample_logits)
from repro_torch.serving.paged_cache import check_decoder_only, n_blocks_for
from repro_torch.serving.scheduler import PagedScheduler, ServeRequest


def load_model(cfg: ModelConfig, rt: Runtime, seed: int):
    """Random weights for ``cfg`` on ``rt.device``, matmul weights cast
    to the compute dtype as each is drawn (the bits of
    ``cast_for_compute`` on the whole fp32 tree, without ever holding
    it: deepseek-v2-lite-16b's is 63 GB).  Returns (params, n_params)."""
    defs = model_defs(cfg)
    params = materialize(defs, prng.PRNGKey(seed), rt.device,
                         cast=compute_cast(cfg))
    return params, count(defs)


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


@dataclass
class Request:
    rid: int
    prompt: torch.Tensor            # (1, S0) int32 on the serving device
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


class ContinuousBatcher:
    """Slot-based continuous batching over the DENSE cache: one shared
    cache of ``n_slots`` sequences decoded in lockstep; an empty slot is
    refilled from the queue by a prefill of the request alone, whose
    cache is spliced into the slot's row.  Kept as the baseline the
    paged engine is held against.  The cache is written in place."""

    def __init__(self, cfg: ModelConfig, params, n_slots: int, ctx_len: int,
                 *, rt: Runtime, temperature: float = 0.0, top_k: int = 0,
                 seed: int = 0):
        check_decoder_only(cfg)
        self.params = params
        self.n, self.ctx = n_slots, ctx_len
        self.device = rt.device
        self.temperature, self.top_k = temperature, top_k
        self.prefill = make_prefill_step(cfg, rt)
        self.step = make_serve_step(cfg, rt, temperature=temperature,
                                    top_k=top_k)
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.cache: Optional[Dict[str, torch.Tensor]] = None
        # each leaf's request axis, found structurally (engine docstring)
        self.batch_axes = cache_batch_axes(cfg)
        self.tok = torch.zeros((n_slots, 1), dtype=torch.int32,
                               device=self.device)
        self.pos = torch.zeros((n_slots,), dtype=torch.int32,
                               device=self.device)
        self._key = prng.PRNGKey(seed)
        self._rng_ctr = 0
        self.prefill_shapes = set()

    def _next_rng(self) -> torch.Tensor:
        rng = prng.fold_in(self._key, self._rng_ctr)
        self._rng_ctr += 1
        return rng

    def _admit(self, req: Request, slot: int) -> None:
        """Prefill the request alone, splice its cache row into the slot.
        The widened cache starts as zeros in every leaf (slot_pos too, as
        in the JAX package), so an empty row attends to its position 0."""
        S0 = req.prompt.shape[1]
        self.prefill_shapes.add((1, S0))
        logits, cache1 = self.prefill(self.params, req.prompt)
        cache1 = pad_cache(cache1, self.ctx - S0)
        if self.cache is None:
            self.cache = {}
            for name, leaf in cache1.items():
                ax = self.batch_axes[name]
                shape = leaf.shape[:ax] + (self.n,) + leaf.shape[ax + 1:]
                self.cache[name] = torch.zeros(shape, dtype=leaf.dtype,
                                               device=leaf.device)
        for name, leaf in cache1.items():
            ax = self.batch_axes[name]
            self.cache[name].select(ax, slot).copy_(leaf.squeeze(ax))
        self.slots[slot] = req
        if self.temperature == 0.0:
            nxt = int(torch.argmax(logits[0, -1]))
        else:
            nxt = int(sample_logits(logits[:, -1], self._next_rng(),
                                    self.temperature, self.top_k)[0])
        req.out.append(nxt)
        req.t_first = time.monotonic()
        self.tok[slot, 0] = nxt
        self.pos[slot] = S0

    def decode_step(self) -> List[Request]:
        """One lockstep decode step.  Returns the requests that finished
        on this step (their slots are freed before returning, so callers
        must use the returned list)."""
        nxt, _, self.cache = self.step(self.params, self.cache, self.tok,
                                       self.pos, self._next_rng())
        self.pos = self.pos + 1
        toks = nxt.tolist()                      # the step's one host sync
        finished: List[Request] = []
        now = time.monotonic()
        for s, req in enumerate(self.slots):
            if req is None or req.done:
                continue
            req.out.append(toks[s])
            if len(req.out) >= req.max_new:
                req.done = True
                req.t_done = now
                finished.append(req)
                self.slots[s] = None
        self.tok = nxt[:, None]
        return finished

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]


def serve_dense(batcher: ContinuousBatcher, prompts: Sequence[np.ndarray],
                max_new: int) -> List[Request]:
    """Serve ``prompts`` on the dense engine, every request queued at
    once, refilling free slots before each lockstep decode step; prints
    the launcher's ``[serve:dense]`` report.  Returns the finished
    requests in the order they finished."""
    t0 = time.monotonic()
    queue = [Request(i, torch.from_numpy(np.asarray(p, np.int32)[None])
                     .to(batcher.device), max_new, t_submit=t0)
             for i, p in enumerate(prompts)]
    finished: List[Request] = []
    steps = 0
    while queue or any(s is not None for s in batcher.slots):
        for s in batcher.free_slots():
            if queue:
                batcher._admit(queue.pop(0), s)
        if any(s is not None for s in batcher.slots):
            finished += batcher.decode_step()
            steps += 1
    report(finished, time.monotonic() - t0, steps, "dense")
    return finished


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
    ap.add_argument("--engine", default="paged", choices=["paged", "dense"])
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


def main(argv: Optional[Sequence[str]] = None):
    """Returns the finished requests: ``ServeRequest``s of the paged
    engine, ``Request``s of the dense one."""
    args = parse_args(argv)
    rt = make_runtime(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = smoke_variant(cfg)
    if cfg.is_encoder_decoder:
        raise SystemExit(
            f"[serve] {cfg.name}: both engines are decoder-only, as in the "
            f"JAX package; an encoder-decoder serves through "
            f"serving.engine.greedy_generate(..., encoder_embeds=) "
            f"(ROADMAP.md Queue C)")
    params, n_params = load_model(cfg, rt, args.seed)
    print(f"[serve] {cfg.name}: {n_params:,} params on {rt.device}")
    ctx = args.prompt_len + args.max_new

    rng = np.random.RandomState(args.seed)
    prompts = [rng.randint(0, cfg.vocab_size, (args.prompt_len,))
               .astype(np.int32) for _ in range(args.requests)]
    if args.engine == "dense":
        batcher = ContinuousBatcher(cfg, params, args.slots, ctx, rt=rt,
                                    temperature=args.temperature,
                                    top_k=args.top_k, seed=args.seed)
        return serve_dense(batcher, prompts, args.max_new)
    sched = build_scheduler(cfg, params, rt, slots=args.slots,
                            block_size=args.block_size, blocks=args.blocks,
                            ctx=ctx, decode_chunk=args.decode_chunk,
                            temperature=args.temperature, top_k=args.top_k,
                            seed=args.seed)
    return serve(sched, prompts, args.max_new)


if __name__ == "__main__":
    main()
