"""Continuous-batching request scheduler over the paged KV cache.

A port of ``repro.serving.scheduler``.  It keeps:

  * **admission by free-block budget**, with copy-on-write prefix
    sharing (``BlockAllocator.plan_prompt``): identical full prompt
    blocks are retained, not rewritten;
  * **bucket-padded batched prefill**: admitted prompts are grouped,
    right-padded to a bucket length and to ``n_slots`` rows, and
    prefilled in one call per bucket; ``last_pos`` picks each row's
    true last-token logits.  An SSM stack scans *through* padding (its
    state would see the pad tokens), so for ``cfg.has_ssm_layers`` the
    buckets are the exact prompt lengths.  The prefill writes the whole
    per-slot state of each admitted slot, so a slot left by a finished
    or preempted request starts clean;
  * **chunked decode**: ``decode_chunk`` lockstep steps run back to back
    on the device and the host syncs once per chunk, to read the
    chunk's tokens (the JAX package runs the chunk as one ``lax.scan``).
    Slot positions and tokens are kept on the host, which knows them
    after the sync, and are uploaded at the start of each chunk.
    Inactive slots point their block table at the scratch block and
    hold ``pos = 0``;
  * **preemption & requeue**: when decode growth needs blocks the pool
    cannot supply, the latest-admitted victim releases its blocks and
    re-enters the queue for full recomputation.

Sampling (``temperature > 0``) folds a counter into ``PRNGKey(seed)``
once per prefill group and once per decode step, where the JAX package's
scheduler does, so the two draw the same keys for the same workload.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.base import ModelConfig
from repro_torch.models.runtime import Runtime
from repro_torch.serving.engine import (make_prefill_step, make_serve_step,
                                        sample_logits)
from repro_torch.serving.paged_cache import (BlockAllocator, PoolExhausted,
                                             check_decoder_only, n_blocks_for,
                                             paged_cache_init, set_block_table,
                                             splice_prefill)


@dataclass
class ServeRequest:
    """One generation request and its lifecycle record."""
    rid: int
    prompt: np.ndarray                  # (S0,) int32 token ids
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False
    # timeline (host wall clock, for latency reporting)
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    token_times: List[float] = field(default_factory=list)
    preemptions: int = 0
    # tokens already folded back into ``prompt`` by preemption recompute
    n_folded: int = 0

    @property
    def n_generated(self) -> int:
        return len(self.out)


def default_buckets(ctx_max: int, lo: int = 8) -> List[int]:
    """Power-of-two prompt-length buckets up to ``ctx_max``."""
    out, b = [], lo
    while b < ctx_max:
        out.append(b)
        b *= 2
    return out + [ctx_max]


class PagedScheduler:
    """Continuous batching over ``n_slots`` lockstep decode lanes backed
    by a shared pool of ``n_blocks`` KV blocks (see module docstring)."""

    def __init__(self, cfg: ModelConfig, params, rt: Runtime, *,
                 n_slots: int, block_size: int, n_blocks: int, ctx_max: int,
                 decode_chunk: int = 4, buckets: Optional[Sequence[int]] = None,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0):
        check_decoder_only(cfg)
        if cfg.window and ctx_max > cfg.window:
            raise ValueError("paged serving keeps windowed caches unrotated "
                             f"(ctx_max {ctx_max} > window {cfg.window})")
        self.cfg, self.params, self.rt = cfg, params, rt
        self.device = rt.device
        self.n_slots, self.block_size = n_slots, block_size
        self.ctx_max = ctx_max
        self.decode_chunk = decode_chunk
        self.temperature, self.top_k = temperature, top_k
        self.nbmax = n_blocks_for(ctx_max, block_size)
        self.buckets = sorted(buckets) if buckets else default_buckets(ctx_max)

        self.alloc = BlockAllocator(n_blocks, block_size)
        self.paged = paged_cache_init(cfg, n_slots, block_size, n_blocks,
                                      self.nbmax, self.device)
        self._prefill = make_prefill_step(cfg, rt)
        self._step = make_serve_step(cfg, rt, temperature=temperature,
                                     top_k=top_k)

        self.queue: Deque[ServeRequest] = deque()
        self.slots: List[Optional[ServeRequest]] = [None] * n_slots
        self.blocks: Dict[int, List[int]] = {}      # slot -> owned block ids
        self._admit_order: List[tuple] = []         # (slot, rid), oldest first
        self.tok = np.zeros((n_slots,), np.int32)   # host: last token per slot
        self.pos = np.zeros((n_slots,), np.int32)   # host: next write position
        self._key = prng.PRNGKey(seed)
        self._rng_ctr = 0

        self.finished: List[ServeRequest] = []
        self.stats = {"prefill_shapes": set(), "decode_shapes": set(),
                      "peak_used_blocks": 0, "preemptions": 0,
                      "decode_steps": 0, "prefill_calls": 0,
                      "cow_shared_blocks": 0,
                      # host seconds from the start of each prefill group
                      # (decode chunk) to the host sync that ends it
                      "prefill_s": 0.0, "decode_s": 0.0}

    # -- submission --------------------------------------------------------

    def submit(self, req: ServeRequest) -> None:
        S0 = len(req.prompt)
        if S0 + req.max_new > self.ctx_max:
            raise ValueError(f"request {req.rid}: {S0}+{req.max_new} exceeds "
                             f"ctx_max {self.ctx_max}")
        req.t_submit = req.t_submit or time.monotonic()
        self.queue.append(req)

    @property
    def idle(self) -> bool:
        return not self.queue and all(r is None for r in self.slots)

    # -- admission (bucket-padded group prefill) ---------------------------

    def _bucket(self, S0: int) -> int:
        if self.cfg.has_ssm_layers:
            return S0            # Mamba scans through padding: exact length
        for b in self.buckets:
            if b >= S0:
                return b
        return self.ctx_max

    def _next_rng(self) -> torch.Tensor:
        rng = prng.fold_in(self._key, self._rng_ctr)
        self._rng_ctr += 1
        return rng

    def admit(self) -> int:
        """Admit as many queued requests as free slots and the block
        budget allow; one batched prefill per occupied bucket.  Returns
        the number of requests admitted."""
        staged: Dict[int, List[tuple]] = {}      # bucket -> [(slot, req, plan)]
        free = [i for i, r in enumerate(self.slots) if r is None]
        while self.queue and free:
            req = self.queue[0]
            S0 = len(req.prompt)
            shared, keys = self.alloc.plan_prompt(req.prompt)
            need = n_blocks_for(S0, self.block_size) - len(shared)
            if self.alloc.n_free < need:
                for bid in shared:               # abandon: undo retains
                    self.alloc.release(bid)
                break                            # admission never preempts
            self.queue.popleft()
            self.stats["cow_shared_blocks"] += len(shared)
            ids = shared + [self.alloc.alloc() for _ in range(need)]
            slot = free.pop(0)
            staged.setdefault(self._bucket(S0), []).append(
                (slot, req, ids, keys, len(shared)))
        for bucket, group in sorted(staged.items()):
            self._prefill_group(bucket, group)
        return sum(len(g) for g in staged.values())

    def _prefill_group(self, bucket: int, group) -> None:
        t0 = time.monotonic()
        toks = np.zeros((self.n_slots, bucket), np.int32)
        last = np.zeros((self.n_slots,), np.int32)
        for i, (_, req, *_rest) in enumerate(group):
            S0 = len(req.prompt)
            toks[i, :S0] = req.prompt
            last[i] = S0 - 1
        self.stats["prefill_shapes"].add((self.n_slots, bucket))
        self.stats["prefill_calls"] += 1
        logits, dense = self._prefill(
            self.params, torch.from_numpy(toks).to(self.device),
            last_pos=torch.from_numpy(last).to(self.device))
        rng = self._next_rng()
        if self.temperature == 0.0:
            first = torch.argmax(logits[:, -1, :], dim=-1)
        else:
            first = sample_logits(logits[:, -1, :], rng, self.temperature,
                                  self.top_k)
        first = first.cpu().numpy()
        now = time.monotonic()
        self.stats["prefill_s"] += now - t0
        for i, (slot, req, ids, keys, n_shared) in enumerate(group):
            set_block_table(self.paged, slot, ids)
            splice_prefill(self.paged, dense, i, slot, ids,
                           skip_blocks=n_shared)
            for j in range(n_shared, len(keys)):   # publish full blocks (COW)
                self.alloc.register(keys[j], ids[j])
            self.slots[slot] = req
            self.blocks[slot] = ids
            self._admit_order.append((slot, req.rid))
            req.out.append(int(first[i]))
            req.t_first = now
            req.token_times.append(now)
            self.tok[slot] = int(first[i])
            self.pos[slot] = len(req.prompt)
            self._finish_if_done(slot, now)
        self.stats["peak_used_blocks"] = max(self.stats["peak_used_blocks"],
                                             self.alloc.used_blocks)

    # -- preemption --------------------------------------------------------

    def _preempt_one(self) -> bool:
        """Evict the latest-admitted active request: release its blocks
        and requeue it (front) for full recompute of prompt+generated."""
        while self._admit_order:
            slot, rid = self._admit_order.pop()
            req = self.slots[slot]
            if req is not None and req.rid == rid:   # skip stale entries
                break
        else:
            return False
        for bid in self.blocks.pop(slot):
            self.alloc.release(bid)
        self._clear_slot(slot)
        # recompute path: tokens emitted since the last admission become
        # prompt again (``out`` keeps the full emitted record)
        req.prompt = np.concatenate(
            [req.prompt, np.asarray(req.out[req.n_folded:], np.int32)])
        req.n_folded = len(req.out)
        req.preemptions += 1
        self.stats["preemptions"] += 1
        self.queue.appendleft(req)
        return True

    def _clear_slot(self, slot: int) -> None:
        self.slots[slot] = None
        # point the table at scratch and park pos at 0
        set_block_table(self.paged, slot, [])
        self.pos[slot] = 0
        self.tok[slot] = 0

    def _grow_blocks(self) -> None:
        """Ensure every active slot owns blocks covering its next
        ``decode_chunk`` writes, preempting (latest first) on demand."""
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            take = min(self.decode_chunk, req.max_new - req.n_generated)
            need = n_blocks_for(int(self.pos[slot]) + take, self.block_size)
            while len(self.blocks.get(slot, [])) < need:
                try:
                    self.blocks[slot].append(self.alloc.alloc())
                except PoolExhausted:
                    # never preempt the slot we are growing unless it is
                    # the only active one (then its own requeue frees us)
                    if not self._preempt_one():
                        raise
                    if self.slots[slot] is None:   # we evicted ourselves
                        break
                    continue
            if self.slots[slot] is not None:
                set_block_table(self.paged, slot, self.blocks[slot])

    # -- decode ------------------------------------------------------------

    def _finish_if_done(self, slot: int, now: float) -> None:
        req = self.slots[slot]
        if req is not None and req.n_generated >= req.max_new:
            req.done = True
            req.t_done = now
            self.finished.append(req)
            for bid in self.blocks.pop(slot):
                self.alloc.release(bid)
            self._clear_slot(slot)

    def decode(self) -> None:
        """One chunk of ``decode_chunk`` lockstep steps on the device,
        with one host sync at its end."""
        self._grow_blocks()
        takes = [0 if r is None else min(self.decode_chunk,
                                         r.max_new - r.n_generated)
                 for r in self.slots]
        if not any(takes):
            return
        # active[i, s]: slot s still emits at step i; a slot whose request
        # finishes mid-chunk freezes (pos held, token pinned), so lockstep
        # never writes past a request's own quota
        t0 = time.monotonic()
        active = torch.tensor([[i < t for t in takes]
                               for i in range(self.decode_chunk)],
                              device=self.device)
        tok = torch.from_numpy(self.tok).to(self.device)
        pos = torch.from_numpy(self.pos).to(self.device)
        rngs = [self._next_rng() for _ in range(self.decode_chunk)]
        self.stats["decode_shapes"].add((self.n_slots, self.decode_chunk))
        outs = []
        for i in range(self.decode_chunk):
            nxt, _, self.paged = self._step(self.params, self.paged,
                                            tok[:, None], pos, rngs[i])
            tok = torch.where(active[i], nxt, tok)
            pos = torch.where(active[i], pos + 1, pos)
            outs.append(tok)
        self.stats["decode_steps"] += self.decode_chunk
        toks = torch.stack(outs).cpu().numpy()      # (k, n_slots) host sync
        now = time.monotonic()
        self.stats["decode_s"] += now - t0
        for slot, req in enumerate(self.slots):
            take = takes[slot]
            if req is None or take == 0:
                continue
            req.out.extend(int(t) for t in toks[:take, slot])
            req.token_times.extend([now] * take)    # chunk-granular stamps
            self.tok[slot] = toks[take - 1, slot]
            self.pos[slot] += take
            self._finish_if_done(slot, now)
        self.stats["peak_used_blocks"] = max(self.stats["peak_used_blocks"],
                                             self.alloc.used_blocks)

    # -- run loop ----------------------------------------------------------

    def step(self) -> None:
        """One scheduler round: admit what fits, then decode a chunk."""
        self.admit()
        self.decode()

    def run(self) -> List[ServeRequest]:
        """Drain queue and slots to completion; returns finished requests."""
        while not self.idle:
            self.step()
        return self.finished

    def compile_counts(self) -> Dict[str, int]:
        """Distinct prefill and decode shapes.  The JAX package compiles
        once per shape; PyTorch runs eagerly, and the count is kept so
        the launcher's report lines match."""
        return {"prefill": len(self.stats["prefill_shapes"]),
                "decode": len(self.stats["decode_shapes"])}
