"""``DataSource`` — the example-level contract every input pipeline
component speaks.  A port of ``repro.data.source``.

A source is a HOST-SIDE, sharded, random-access view of a dataset:

  * ``shard_lengths()`` — examples per shard (the unit of shuffling and
    of per-process partitioning in ``loader.StreamingLoader``);
  * ``read(shard, start, count)`` — a dict of CPU tensors, each with a
    leading example dimension, for ``count`` consecutive examples of one
    shard.  Reads are pure: the same (shard, start, count) always
    returns the same bits, which is what makes the loader's
    ``LoaderState`` sufficient for exact-batch deterministic resume.

Sources never touch the card — host-to-device movement is the
prefetcher's job (``data.prefetch``) — and never hold iterator state;
cursors live in ``LoaderState`` so they can ride the checkpoint.

Implementations: ``MemorySource`` (in-RAM arrays, below),
``SyntheticLM`` (``data.synthetic``) and ``DiskShardedSource`` over the
``repro-data-pack`` on-disk format (``data.format``).
"""
from __future__ import annotations

from typing import Dict, Optional, Protocol, Tuple, runtime_checkable

import numpy as np
import torch


@runtime_checkable
class DataSource(Protocol):
    """Structural protocol — any object with these two methods is a
    source (``isinstance`` works via ``runtime_checkable``)."""

    def shard_lengths(self) -> Tuple[int, ...]:
        """Number of examples in each shard, in shard order."""
        ...

    def read(self, shard: int, start: int, count: int) -> Dict[str, torch.Tensor]:
        """``count`` consecutive examples of ``shard`` beginning at
        ``start``: a dict of CPU tensors, each shaped ``(count, ...)``.
        Must raise ``IndexError``/``ValueError`` on out-of-range reads
        rather than silently truncating."""
        ...


def n_examples(source: DataSource) -> int:
    """Total examples per epoch across all shards."""
    return int(sum(source.shard_lengths()))


def check_read_range(lengths: Tuple[int, ...], shard: int, start: int,
                     count: int) -> None:
    """Shared bounds check for ``read`` implementations (loud, never
    truncating — a silent short read would corrupt loader determinism)."""
    if not 0 <= shard < len(lengths):
        raise IndexError(f"shard {shard} out of range (have {len(lengths)})")
    if count < 0 or start < 0 or start + count > lengths[shard]:
        raise ValueError(
            f"read [{start}:{start + count}) out of range for shard "
            f"{shard} of length {lengths[shard]}")


class MemorySource:
    """In-RAM arrays as a (virtually) sharded source.

    ``arrays`` is a dict of equal-leading-length numpy arrays or tensors
    (the fields of one example batch), kept as CPU tensors;
    ``shard_size`` slices them into virtual shards so shuffling and
    partitioning behave exactly as they would over the on-disk format.
    The default is one shard.
    """

    def __init__(self, arrays: Dict[str, object],
                 shard_size: Optional[int] = None):
        if not arrays:
            raise ValueError("MemorySource needs at least one field")
        self.arrays = {k: v.detach().cpu() if isinstance(v, torch.Tensor)
                       else torch.from_numpy(np.array(v))
                       for k, v in arrays.items()}
        n = {k: v.shape[0] for k, v in self.arrays.items()}
        if len(set(n.values())) != 1:
            raise ValueError(f"fields disagree on example count: {n}")
        self.n = next(iter(n.values()))
        if self.n == 0:
            raise ValueError("MemorySource needs at least one example")
        step = shard_size or self.n
        if step <= 0:
            raise ValueError(f"shard_size must be positive, got {step}")
        self._bounds = [(s, min(s + step, self.n))
                        for s in range(0, self.n, step)]

    def shard_lengths(self) -> Tuple[int, ...]:
        return tuple(e - s for s, e in self._bounds)

    def read(self, shard: int, start: int, count: int) -> Dict[str, torch.Tensor]:
        check_read_range(self.shard_lengths(), shard, start, count)
        s0 = self._bounds[shard][0] + start
        return {k: v[s0:s0 + count] for k, v in self.arrays.items()}
