"""Paged KV cache: a global block pool + per-sequence block tables.

A port of ``repro.serving.paged_cache`` for the decoder-only stacks
(``check_decoder_only``: an encoder-decoder is refused, as the JAX
package asserts; it serves through ``engine.greedy_generate``).
Each attention layer's cache is a pool of fixed-size blocks plus an
int32 block table per slot, kept in a flat dict stacked over periods:

    "blocks.L{i}.attn.kp" / ".vp"   (n_periods, n_blocks, bs, K, hd)
    "blocks.L{i}.attn.bt"           (n_periods, n_slots, nbmax) int32

An MLA layer pools its latents instead, "ckvp" (..., n_blocks, bs, r)
and "kropep" (..., n_blocks, bs, rr).  A prefix layer's leaves
("prefix.P{i}.attn.*") carry no leading period dim.  A Mamba2 layer's
fixed-size state is left per slot, as in the dense cache: there is
nothing to page in an O(1) recurrent state.

    "blocks.L{i}.mamba.conv"        (n_periods, n_slots, W-1, conv_dim)
    "blocks.L{i}.mamba.ssm"         (n_periods, n_slots, H, P, N) fp32

A hybrid (jamba) holds both kinds in one dict, keyed by each layer's
mixer: pools and tables for its attention layer, per-slot state for its
Mamba2 layers.  ``splice_prefill`` skips a COW-shared prefix's pool
blocks but writes every per-slot state row whole, and copy-on-write
shares pool blocks only.  A pure SSM stack has no pools at all; its
requests still take blocks from the allocator, as in the JAX package, so
admission, preemption and the block counters follow the same schedule.

Token position t of slot b lives at ``pool[bt[b, t // bs], t % bs]``.
Block 0 is a reserved scratch block: inactive slots point their whole
table at it, so lockstep decode writes land somewhere harmless.

``BlockAllocator`` is a copy of the JAX package's host-side free-list
allocator with refcounted copy-on-write prefix sharing at full-block
granularity (the port does not import the JAX package).  Pool shapes
come from ``cfg`` directly.  The pools and tables are updated in place
(``index_put_`` / slice assignment) where the JAX package builds
functional copies.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, layer_pattern
from repro_torch.models.mamba import state_shapes
from repro_torch.models.transformer import mixer_name

# pool leaf -> (dense prefill leaf, number of trailing dims after (B, S))
POOL_LEAVES = {"kp": ("k", 2), "vp": ("v", 2),
               "ckvp": ("ckv", 1), "kropep": ("krope", 1)}

# per-slot (unpaged) leaf -> its batch axis counted from the end (leaves
# may lead with the stacked period dim): conv (B, W-1, conv_dim), ssm
# (B, H, P, N)
SLOT_BATCH_AXIS_FROM_END = {"conv": 3, "ssm": 4}


def n_blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` positions."""
    return -(-n_tokens // block_size)


class PoolExhausted(RuntimeError):
    """The free list is empty; the scheduler preempts and retries."""


class BlockAllocator:
    """Host-side free-list allocator over ``n_blocks`` KV blocks with
    refcounted full-block prefix sharing (see module docstring)."""

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 2:
            raise ValueError("need at least scratch block 0 + one real block")
        self.n_blocks = n_blocks
        self.block_size = block_size
        # LIFO free list, block 0 reserved as scratch; low ids first out
        self._free: List[int] = list(range(n_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        self._hash2block: Dict[Any, int] = {}
        self._block2hash: Dict[int, Any] = {}

    # -- core alloc/free ---------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return (self.n_blocks - 1) - len(self._free)

    def refcount(self, bid: int) -> int:
        return self._ref.get(bid, 0)

    def alloc(self) -> int:
        if not self._free:
            raise PoolExhausted(f"all {self.n_blocks - 1} blocks in use")
        bid = self._free.pop()
        self._ref[bid] = 1
        return bid

    def retain(self, bid: int) -> int:
        assert self._ref.get(bid, 0) > 0, f"retain of free block {bid}"
        self._ref[bid] += 1
        return bid

    def release(self, bid: int) -> None:
        assert self._ref.get(bid, 0) > 0, f"release of free block {bid}"
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            del self._ref[bid]
            h = self._block2hash.pop(bid, None)
            if h is not None:
                del self._hash2block[h]
            self._free.append(bid)

    # -- copy-on-write prefix sharing --------------------------------------

    @staticmethod
    def prefix_key(prev_key: Any, block_tokens: Tuple[int, ...]) -> Any:
        """Chained content key: a block's identity is (everything before
        it, its tokens)."""
        return (prev_key, block_tokens)

    def lookup(self, key: Any) -> Optional[int]:
        return self._hash2block.get(key)

    def register(self, key: Any, bid: int) -> None:
        """Publish a freshly written full block for reuse.  First writer
        wins; keys/blocks already mapped are left alone."""
        if key not in self._hash2block and bid not in self._block2hash:
            self._hash2block[key] = bid
            self._block2hash[bid] = key

    def plan_prompt(self, tokens) -> Tuple[List[int], List[Any]]:
        """COW admission plan for a prompt: ``(shared_block_ids,
        full_block_keys)``.  The shared blocks (the longest registered
        chain of the prompt's full blocks) are *retained* here; the
        caller releases them if admission is abandoned."""
        toks = [int(t) for t in tokens]
        bs = self.block_size
        keys: List[Any] = []
        prev: Any = None
        for i in range(len(toks) // bs):
            prev = self.prefix_key(prev, tuple(toks[i * bs:(i + 1) * bs]))
            keys.append(prev)
        shared: List[int] = []
        for key in keys:
            bid = self.lookup(key)
            if bid is None:
                break
            shared.append(self.retain(bid))
        return shared, keys

    def check(self) -> None:
        """Invariants: conservation, scratch never handed out, free list
        duplicate-free, hash maps consistent."""
        assert self.used_blocks == len(self._ref)
        assert self.used_blocks + self.n_free == self.n_blocks - 1
        assert 0 not in self._ref and 0 not in self._free
        assert len(set(self._free)) == len(self._free)
        for h, b in self._hash2block.items():
            assert self._block2hash.get(b) == h and self._ref.get(b, 0) > 0


# ---------------------------------------------------------------------------
# paged cache construction & manipulation
# ---------------------------------------------------------------------------

def check_decoder_only(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for an encoder-decoder (Whisper): both serving
    engines, paged and the dense batcher, are decoder-only in the JAX
    package too (ROADMAP.md Queue C)."""
    if cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name}: the serving engines are decoder-only, "
                         f"as in the JAX package (an encoder-decoder serves "
                         f"through serving.engine.greedy_generate; ROADMAP.md "
                         f"Queue C)")


def paged_cache_init(cfg: ModelConfig, n_slots: int, block_size: int,
                     n_blocks: int, nbmax: int,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    """Zero-initialized pools and block tables for every attention
    layer, prefix and period, in the compute dtype that prefill writes,
    and zero per-slot state for every Mamba2 layer (see module
    docstring)."""
    check_decoder_only(cfg)
    prefix, period, n_periods = layer_pattern(cfg)
    if cfg.mla is not None:
        tails = {"ckvp": (cfg.mla.kv_lora_rank,), "kropep": (cfg.mla.qk_rope_dim,)}
    elif cfg.n_heads:
        tails = dict.fromkeys(("kp", "vp"),
                              (cfg.n_kv_heads, cfg.resolved_head_dim))
    else:                                  # attention-free: no pools
        tails = {}
    cdt = getattr(torch, cfg.compute_dtype)
    layers = ([(f"prefix.P{i}.", s, ()) for i, s in enumerate(prefix)]
              + [(f"blocks.L{j}.", s, (n_periods,)) for j, s in enumerate(period)])
    paged = {}
    for pre, spec, lead in layers:
        if mixer_name(spec) == "mamba":
            for name, (shape, dt) in state_shapes(cfg, n_slots).items():
                paged[pre + "mamba." + name] = torch.zeros(
                    lead + shape, dtype=dt, device=device)
            continue
        for name, tail in tails.items():
            paged[pre + "attn." + name] = torch.zeros(
                lead + (n_blocks, block_size) + tail, dtype=cdt, device=device)
        paged[pre + "attn.bt"] = torch.zeros(lead + (n_slots, nbmax),
                                             dtype=torch.int32, device=device)
    return paged


def set_block_table(paged, slot: int, block_ids: List[int]):
    """Point slot ``slot``'s table row (every layer) at ``block_ids``,
    zero-padded (scratch) to the table width."""
    for name, leaf in paged.items():
        if not name.endswith(".bt"):
            continue
        nbmax = leaf.shape[-1]
        assert len(block_ids) <= nbmax, (len(block_ids), nbmax)
        row = torch.tensor(list(block_ids) + [0] * (nbmax - len(block_ids)),
                           dtype=torch.int32)
        leaf[..., slot, :] = row.to(leaf.device)
    return paged


def splice_prefill(paged, dense, row: int, slot: int, block_ids: List[int],
                   skip_blocks: int = 0):
    """Write row ``row`` of a (group) dense prefill cache into the pool
    blocks ``block_ids`` and into per-slot row ``slot`` of the per-slot
    state (the whole row: a preempted or finished request's state there
    is replaced).  The first ``skip_blocks`` blocks are COW-shared
    (already holding this prefix) and are not written.  Block tables are
    untouched: use ``set_block_table``."""
    ids = block_ids[skip_blocks:]
    for name, pool in paged.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in SLOT_BATCH_AXIS_FROM_END:
            ax = pool.dim() - SLOT_BATCH_AXIS_FROM_END[leaf]
            pool.select(ax, slot).copy_(dense[name].select(ax, row))
            continue
        if leaf not in POOL_LEAVES or not ids:
            continue
        dense_leaf, tail_nd = POOL_LEAVES[leaf]
        src = dense[name[:-len(leaf)] + dense_leaf]    # ([n_p,] B, S, ...)
        if pool.dim() == 2 + tail_nd:                  # a prefix layer
            pool, src = pool.unsqueeze(0), src.unsqueeze(0)
        _splice_pool(pool, src[:, row], block_ids, skip_blocks)
    return paged


def _splice_pool(pool, sel, block_ids: List[int], skip_blocks: int):
    """pool (n_p, nb, bs, *tail) <- sel (n_p, S, *tail), in place."""
    bs = pool.shape[2]
    L = len(block_ids) * bs
    S = sel.shape[1]
    if S < L:                                        # pad up to block cover
        pad = sel.new_zeros((sel.shape[0], L - S) + tuple(sel.shape[2:]))
        sel = torch.cat([sel, pad], dim=1)
    chunk = sel[:, :L].reshape((sel.shape[0], len(block_ids), bs)
                               + tuple(sel.shape[2:]))
    ids = torch.tensor(block_ids[skip_blocks:], dtype=torch.long,
                       device=pool.device)
    pool[:, ids] = chunk[:, skip_blocks:].to(pool.dtype)


def paged_kv_bytes_per_block(paged) -> int:
    """Bytes of pool storage per block, summed over every attention
    layer (the unit of the O(used-blocks) memory claim)."""
    total = 0
    for name, leaf in paged.items():
        base = name.rsplit(".", 1)[-1]
        if base in POOL_LEAVES:
            n_blocks = leaf.shape[leaf.dim() - 2 - POOL_LEAVES[base][1]]
            total += leaf.numel() * leaf.element_size() // n_blocks
    assert total, "no pool leaves found"
    return total
