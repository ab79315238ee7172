"""repro_torch.data — the input pipeline, a port of ``repro.data``.

Layers, bottom to top:

  * ``source``   — the ``DataSource`` protocol (sharded, host-side,
                   random-access examples as CPU tensors) + ``MemorySource``;
  * ``synthetic``— deterministic synthetic sources (``SyntheticLM``
                   bigram language, ``synthetic_images`` CIFAR proxy);
  * ``format``   — the ``repro-data-pack`` on-disk sharded format
                   (``pack_dataset``/``DataPackWriter`` writers,
                   ``DiskShardedSource`` reader; CLI:
                   ``python -m repro_torch.data.pack``);
  * ``loader``   — ``StreamingLoader``: per-process sharded batches,
                   seekable via the serializable ``LoaderState`` that
                   rides the checkpoint (exact-batch resume);
  * ``prefetch`` — ``PrefetchIterator``: background host-to-device
                   prefetch (pinned, a side stream, an event per batch)
                   with input-stall and queue-depth counters.
"""
from repro_torch.data.format import (DataPackWriter, DiskShardedSource,
                                     pack_dataset, pack_iterable)
from repro_torch.data.loader import LoaderState, StreamingLoader
from repro_torch.data.prefetch import PrefetchIterator, device_put_batch
from repro_torch.data.source import DataSource, MemorySource, n_examples
from repro_torch.data.synthetic import (SyntheticLM, synthetic_images,
                                        synthetic_images_source)

__all__ = [
    "DataSource", "MemorySource", "n_examples",
    "SyntheticLM", "synthetic_images", "synthetic_images_source",
    "DataPackWriter", "DiskShardedSource", "pack_dataset", "pack_iterable",
    "LoaderState", "StreamingLoader",
    "PrefetchIterator", "device_put_batch",
]
