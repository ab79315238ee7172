"""``repro-data-pack`` — the on-disk sharded array/token format.  A port
of ``repro.data.format``: either package reads the other's packs.

A packed dataset is a directory:

    dataset/
      shard_00000.npz     # one array per field, shape (n_0, *field_shape)
      shard_00001.npz
      ...
      dataset.json        # written LAST = the commit marker

``dataset.json``::

    {"format": 1,
     "fields": {"tokens": {"dtype": "int32", "shape": [128]}, ...},
     "shard_lengths": [1024, 1024, ...],
     "meta": {...}}        # free-form provenance (vocab size, seq len, ...)

Design points (the JAX package's):

  * the index file is written last, so a crash mid-pack can never leave
    a directory that LOOKS like a dataset (readers require it);
  * shards are uncompressed ``.npz``;
  * dtypes numpy cannot save (bfloat16, float8_*) are stored as
    same-width unsigned views with the true dtype name recorded per
    field, so any field round-trips bit-exactly.  Without ``ml_dtypes``
    the port turns the bits into a torch tensor of that dtype through a
    signed view (bf16: ``uint16`` -> ``int16`` -> ``torch.bfloat16``);
  * shard size is the SHUFFLE GRANULARITY: ``StreamingLoader`` permutes
    shard order per epoch but reads within a shard sequentially, so
    pack with small shards for good mixing.

For the same input the index is byte for byte the JAX package's
(``json.dump(index, f, indent=1, sort_keys=True)``, the same dtype
names); the shard files hold the same arrays (zip headers carry
timestamps, so not the same bytes).

``pack_dataset`` packs in-memory arrays; ``DataPackWriter`` streams
example batches of unknown total length; ``python -m
repro_torch.data.pack`` is the CLI around both.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.source import check_read_range

PACK_FORMAT = 1
INDEX_NAME = "dataset.json"


def _np_savable(dt: np.dtype) -> bool:
    """True iff the .npy descr string round-trips this dtype (extension
    dtypes like bfloat16 silently degrade to void records otherwise)."""
    import warnings
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            descr = np.lib.format.dtype_to_descr(dt)
            return np.lib.format.descr_to_dtype(descr) == dt
    except Exception:
        return False


def _stored(v) -> Tuple[np.ndarray, str]:
    """A field (tensor or array) as the numpy array a shard stores and its
    true dtype name: a dtype numpy cannot save as its unsigned bits."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        try:
            return t.numpy(), name
        except TypeError:                    # bfloat16, float8_*
            size = t.element_size()
            bits = t.view({1: torch.uint8, 2: torch.int16}[size]).numpy()
            return bits.view(f"uint{8 * size}"), name
    a = np.asarray(v)
    if _np_savable(a.dtype):
        return a, a.dtype.name
    return a.view(f"uint{8 * a.dtype.itemsize}"), a.dtype.name


def _tensor(a: np.ndarray, name: str) -> torch.Tensor:
    """A stored array as a CPU tensor of its true dtype ``name``."""
    if a.dtype.name == name:
        return torch.from_numpy(a)
    want = getattr(torch, name, None)
    if not isinstance(want, torch.dtype) or a.dtype.kind != "u":
        raise TypeError(f"cannot read a {a.dtype} array as {name!r}")
    return torch.from_numpy(a.view(f"int{8 * a.dtype.itemsize}")).view(want)


def shard_name(i: int) -> str:
    return f"shard_{i:05d}.npz"


class DataPackWriter:
    """Streaming pack writer: feed example batches (dicts of tensors or
    numpy arrays) with ``add``; shards of ``shard_size`` examples are
    flushed as they fill and the index is committed by ``close()`` (or
    the ``with`` exit).  A directory with no ``dataset.json`` is an
    aborted pack and is refused by readers."""

    def __init__(self, out_dir: str, shard_size: int = 1024,
                 meta: Optional[Dict[str, Any]] = None):
        if shard_size <= 0:
            raise ValueError(f"shard_size must be positive, got {shard_size}")
        if os.path.exists(os.path.join(out_dir, INDEX_NAME)):
            raise ValueError(f"{out_dir!r} already holds a packed dataset; "
                             f"refusing to overwrite")
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.shard_size = shard_size
        self.meta = dict(meta or {})
        self._fields: Optional[Dict[str, Dict[str, Any]]] = None
        self._buf: Dict[str, list] = {}
        self._buffered = 0
        self._shard_lengths: list = []
        self._closed = False

    def add(self, batch: Dict[str, Any]) -> None:
        stored = {k: _stored(v) for k, v in batch.items()}
        ns = {k: a.shape[0] for k, (a, _) in stored.items()}
        if len(set(ns.values())) != 1:
            raise ValueError(f"fields disagree on example count: {ns}")
        fields = {k: {"dtype": name, "shape": list(a.shape[1:])}
                  for k, (a, name) in stored.items()}
        if self._fields is None:
            self._fields = fields
            self._buf = {k: [] for k in fields}
        elif fields != self._fields:
            raise ValueError(f"batch schema {fields} != first batch's "
                             f"{self._fields}")
        for k, (a, _) in stored.items():
            self._buf[k].append(a)
        self._buffered += next(iter(ns.values()))
        while self._buffered >= self.shard_size:
            self._flush(self.shard_size)

    def _flush(self, n: int) -> None:
        if n == 0:
            return
        cat = {k: np.concatenate(v) if len(v) > 1 else v[0]
               for k, v in self._buf.items()}
        np.savez(os.path.join(self.out_dir,
                              shard_name(len(self._shard_lengths))),
                 **{k: v[:n] for k, v in cat.items()})
        self._shard_lengths.append(n)
        self._buf = {k: [v[n:]] for k, v in cat.items()}
        self._buffered -= n

    def close(self) -> str:
        """Flush the tail shard and commit the index; returns the index
        path.  Idempotent."""
        if self._closed:
            return os.path.join(self.out_dir, INDEX_NAME)
        if self._fields is None or (not self._shard_lengths
                                    and self._buffered == 0):
            raise ValueError("nothing packed: add at least one example")
        self._flush(self._buffered)
        index = {"format": PACK_FORMAT, "fields": self._fields,
                 "shard_lengths": self._shard_lengths, "meta": self.meta}
        with open(os.path.join(self.out_dir, INDEX_NAME), "w") as f:
            json.dump(index, f, indent=1, sort_keys=True)
        self._closed = True
        return os.path.join(self.out_dir, INDEX_NAME)

    def __enter__(self) -> "DataPackWriter":
        return self

    def __exit__(self, exc_type, *_) -> None:
        if exc_type is None:
            self.close()


def pack_dataset(out_dir: str, arrays: Dict[str, Any],
                 shard_size: int = 1024,
                 meta: Optional[Dict[str, Any]] = None) -> str:
    """Pack in-memory arrays (dict of equal-leading-length fields) into
    ``out_dir``; returns the committed index path."""
    with DataPackWriter(out_dir, shard_size=shard_size, meta=meta) as w:
        w.add(arrays)
    return os.path.join(out_dir, INDEX_NAME)


def pack_iterable(out_dir: str, batches: Iterable[Dict[str, Any]],
                  shard_size: int = 1024,
                  meta: Optional[Dict[str, Any]] = None) -> str:
    """Pack a stream of example batches of unknown total length."""
    with DataPackWriter(out_dir, shard_size=shard_size, meta=meta) as w:
        for b in batches:
            w.add(b)
    return os.path.join(out_dir, INDEX_NAME)


class DiskShardedSource:
    """``DataSource`` over a ``repro-data-pack`` directory.

    A shard's arrays are read whole when it is first touched and kept in
    a tiny (2-entry) cache — the loader reads a shard front to back, so
    at most the current and the next shard stay in memory.  A read
    returns fresh CPU tensors of each field's true dtype, bit-exact.
    """

    _CACHE = 2

    def __init__(self, path: str):
        index_p = os.path.join(path, INDEX_NAME)
        if not os.path.exists(index_p):
            raise FileNotFoundError(
                f"{path!r} is not a packed dataset (no {INDEX_NAME}; an "
                f"aborted pack leaves no index — re-run the packer)")
        with open(index_p) as f:
            index = json.load(f)
        if index.get("format") != PACK_FORMAT:
            raise ValueError(f"{index_p}: unknown pack format "
                             f"{index.get('format')!r} (this reader "
                             f"understands {PACK_FORMAT})")
        self.path = path
        self.fields: Dict[str, Dict[str, Any]] = index["fields"]
        self._lengths = tuple(int(n) for n in index["shard_lengths"])
        self.meta: Dict[str, Any] = index.get("meta", {})
        self._open: Dict[int, Dict[str, np.ndarray]] = {}

    def shard_lengths(self) -> Tuple[int, ...]:
        return self._lengths

    def _shard(self, i: int) -> Dict[str, np.ndarray]:
        if i not in self._open:
            if len(self._open) >= self._CACHE:
                self._open.pop(next(iter(self._open)))
            with np.load(os.path.join(self.path, shard_name(i))) as data:
                self._open[i] = {k: data[k] for k in self.fields}
        return self._open[i]

    def read(self, shard: int, start: int, count: int) -> Dict[str, torch.Tensor]:
        check_read_range(self._lengths, shard, start, count)
        data = self._shard(shard)
        return {k: _tensor(data[k][start:start + count].copy(), spec["dtype"])
                for k, spec in self.fields.items()}

    def close(self) -> None:
        self._open.clear()
