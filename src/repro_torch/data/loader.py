"""``StreamingLoader`` — a per-process, sharded, seekable batch stream.
A port of ``repro.data.loader``: for the same source, batch size, seed
and process layout it yields the JAX loader's batches, bit for bit, as
CPU tensors, and its ``LoaderState`` is the same JSON, so a cursor saved
by either package's launcher resumes in the other.

  * **per-process sharding** — with ``process_count`` processes, process
    ``p`` owns source shards ``p, p+P, p+2P, ...`` (round-robin) and
    yields the LOCAL ``batch_size / process_count`` rows of every global
    batch; the global batch is the concatenation across processes, in
    process order.  The port takes ``process_index``/``process_count``
    as arguments (default 0 of 1): nothing wires them to
    ``torch.distributed`` yet.
  * **determinism** — shard order is permuted per epoch by a numpy
    ``SeedSequence`` over (key, epoch), the key being the words of
    ``PRNGKey(seed)``; within a shard reads are sequential, so the shard
    is the shuffle granularity.  Batch ``t`` is a pure function of
    (source, batch size, key, process layout).
  * **seekability** — the full iterator position is a four-field
    ``LoaderState`` (epoch, shard cursor, within-shard offset, key).
    ``loader.state`` after consuming batch ``t`` describes batch
    ``t+1``; constructing a loader with ``state=`` (or calling ``seek``)
    resumes so that the next batch is BITWISE the batch an uninterrupted
    run would have produced.  The state is JSON-trivial and rides the
    checkpoint (``checkpoint/io.py`` ``loader_state``).

Epoch tails smaller than one local batch are dropped (``drop_last``) and
batches never mix epochs, so every yielded batch has a fixed shape.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.data.source import DataSource


@dataclasses.dataclass
class LoaderState:
    """Serializable cursor of a ``StreamingLoader``: everything needed
    to reproduce the rest of the stream bit-for-bit.  ``key`` is the
    base key's two uint32 words (the per-epoch permutation derives from
    it; storing the base key keeps every future epoch exact)."""
    epoch: int = 0
    shard_cursor: int = 0
    offset: int = 0
    key: Tuple[int, int] = (0, 0)

    def to_dict(self) -> Dict[str, Any]:
        return {"epoch": int(self.epoch),
                "shard_cursor": int(self.shard_cursor),
                "offset": int(self.offset),
                "key": [int(self.key[0]), int(self.key[1])]}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LoaderState":
        missing = {"epoch", "shard_cursor", "offset", "key"} - set(d)
        if missing:
            raise ValueError(f"loader state missing fields {sorted(missing)}")
        return cls(epoch=int(d["epoch"]), shard_cursor=int(d["shard_cursor"]),
                   offset=int(d["offset"]),
                   key=(int(d["key"][0]), int(d["key"][1])))


def _key_data(seed: int) -> Tuple[int, int]:
    k = prng.PRNGKey(seed).tolist()
    return int(k[0]), int(k[1])


def _epoch_perm(key: Tuple[int, int], epoch: int, n: int) -> np.ndarray:
    """Permutation of ``n`` local shards for ``epoch``, derived from the
    base key by a plain numpy SeedSequence over (key, epoch)."""
    rng = np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([key[0], key[1], epoch])))
    return rng.permutation(n)


class StreamingLoader:
    """See module docstring.  ``batch_size`` is the GLOBAL batch; the
    loader yields this process's ``batch_size // process_count`` rows.

    ``max_epochs=None`` streams forever (training bounds the run by
    steps); an int raises ``StopIteration`` once that many epochs are
    exhausted.  ``shuffle=False`` keeps shard order fixed — useful for
    evaluation sweeps.
    """

    def __init__(self, source: DataSource, batch_size: int, *,
                 seed: int = 0, shuffle: bool = True,
                 max_epochs: Optional[int] = None,
                 process_index: int = 0, process_count: int = 1,
                 state: Optional[LoaderState] = None):
        P, p = process_count, process_index
        if not 0 <= p < P:
            raise ValueError(f"process_index {p} out of range for {P}")
        if batch_size % P:
            raise ValueError(f"global batch {batch_size} must divide across "
                             f"{P} processes")
        self.source = source
        self.batch_size = batch_size
        self.local_batch = batch_size // P
        self.shuffle = shuffle
        self.max_epochs = max_epochs
        lengths = tuple(source.shard_lengths())
        self._my_shards = tuple(range(p, len(lengths), P))
        self._my_lengths = tuple(lengths[s] for s in self._my_shards)
        if not self._my_shards:
            raise ValueError(f"process {p}/{P} owns no shards "
                             f"({len(lengths)} total); pack more shards")
        if sum(self._my_lengths) < self.local_batch:
            raise ValueError(
                f"process {p} owns {sum(self._my_lengths)} examples < local "
                f"batch {self.local_batch}; every epoch would be empty")
        self._st = dataclasses.replace(
            state if state is not None else LoaderState(key=_key_data(seed)))
        self._perm_epoch: Optional[int] = None
        self._perm: Optional[np.ndarray] = None

    # -- state ----------------------------------------------------------
    @property
    def state(self) -> LoaderState:
        """The cursor of the NEXT batch (snapshot — safe to serialize)."""
        return dataclasses.replace(self._st)

    def seek(self, state: LoaderState) -> None:
        self._st = dataclasses.replace(state)
        self._perm_epoch = None

    # -- iteration ------------------------------------------------------
    def _order(self, epoch: int) -> np.ndarray:
        """This epoch's local-shard visit order (cached per epoch)."""
        if self._perm_epoch != epoch:
            n = len(self._my_shards)
            self._perm = (_epoch_perm(self._st.key, epoch, n)
                          if self.shuffle else np.arange(n))
            self._perm_epoch = epoch
        return self._perm

    def _advance_epoch(self) -> None:
        self._st.epoch += 1
        self._st.shard_cursor = 0
        self._st.offset = 0
        if self.max_epochs is not None and self._st.epoch >= self.max_epochs:
            raise StopIteration

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        st = self._st
        if self.max_epochs is not None and st.epoch >= self.max_epochs:
            raise StopIteration
        parts = []
        need = self.local_batch
        while need > 0:
            order = self._order(st.epoch)
            if st.shard_cursor >= len(order):
                # epoch exhausted mid-batch: drop the tail (drop_last)
                # and start the batch over in the next epoch — batches
                # never mix epochs, so shapes stay fixed
                parts, need = [], self.local_batch
                self._advance_epoch()
                continue
            local = int(order[st.shard_cursor])
            length = self._my_lengths[local]
            take = min(need, length - st.offset)
            if take > 0:
                part = self.source.read(self._my_shards[local],
                                        st.offset, take)
                parts.append(part)
                st.offset += take
                need -= take
            if st.offset >= length:
                st.shard_cursor += 1
                st.offset = 0
        if len(parts) == 1:
            batch = dict(parts[0])
        else:
            batch = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        for k, v in batch.items():
            if v.shape[0] != self.local_batch:
                raise ValueError(f"source returned short read for {k!r}: "
                                 f"{v.shape[0]} != {self.local_batch}")
        return batch

    # -- bookkeeping ----------------------------------------------------
    def batches_per_epoch(self) -> int:
        """Batches this process yields per epoch (drop_last floor)."""
        return sum(self._my_lengths) // self.local_batch

    def close(self) -> None:
        close = getattr(self.source, "close", None)
        if close is not None:
            close()
