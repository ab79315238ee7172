"""Deterministic synthetic data (no datasets ship offline).  A port of
``repro.data.synthetic``.

* ``SyntheticLM`` — token sequences from a fixed random bigram chain with
  controllable branching, a learnable distribution (its entropy is
  log(branching) nats).
* ``synthetic_images`` — class-conditional Gaussian-blob images, the
  CIFAR10 stand-in of the paper's Table 2.

The successor table comes from ``np.random.RandomState(seed)`` and the
start tokens and branch choices from ``repro_torch.prng``, keyed as the
JAX package keys them, so batch ``i`` of ``batch_at`` and example ``j``
of ``read`` are bitwise the JAX package's for the same seed.  The two
streams draw from independent fold-in domains, so a loader-driven run
and a ``batch_at`` run are both deterministic but not example for
example the same.  The images are plain numpy, the JAX package's own
draws.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.data.source import MemorySource, check_read_range


class SyntheticLM:
    """Bigram chain: the next token is uniform over ``branching``
    successors of the current one (table fixed by ``seed``).

    As a ``DataSource`` the nominal epoch is ``epoch_examples`` examples
    in ``n_shards`` equal virtual shards (the chain itself is infinite;
    the epoch size just gives the loader a shuffle/epoch structure).
    ``device`` is where ``batch_at`` puts its batches; ``read`` returns
    CPU tensors, as every source does."""

    def __init__(self, vocab_size: int, seq_len: int, batch_size: int,
                 seed: int = 0, branching: int = 4,
                 epoch_examples: int = 65536, n_shards: int = 16,
                 device: Optional[torch.device] = None):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = batch_size
        self.branching = branching
        self.seed = seed
        self.device = torch.device("cpu") if device is None else device
        rng = np.random.RandomState(seed)
        self.table = rng.randint(0, vocab_size,
                                 size=(vocab_size, branching)).astype(np.int32)
        if epoch_examples % n_shards:
            raise ValueError(f"epoch_examples {epoch_examples} must divide "
                             f"into {n_shards} shards")
        self.epoch_examples = epoch_examples
        self.n_shards = n_shards

    def walk(self, tok0: np.ndarray, choices: np.ndarray) -> np.ndarray:
        """(n,) start tokens + (n, S) branch choices -> (n, S) tokens:
        tokens[:, 0] = tok0, tokens[:, t] = table[tokens[:, t-1],
        choices[:, t-1]] (the JAX package's ``_walk``)."""
        n, S = choices.shape
        toks = np.empty((n, S), np.int32)
        tok = np.asarray(tok0, np.int32)
        for t in range(S):
            toks[:, t] = tok
            tok = self.table[tok, choices[:, t]]
        return toks

    def batch_at(self, i: int) -> Dict[str, torch.Tensor]:
        """Batch ``i`` of ``batch_size`` sequences, on ``device``: the
        draws of ``repro.data.synthetic.SyntheticLM.batch_at``."""
        k0, k1 = prng.split(prng.fold_in(prng.PRNGKey(self.seed), i))
        tok0 = prng.randint(k0, (self.batch,), 0, self.vocab)
        choices = prng.randint(k1, (self.batch, self.seq), 0, self.branching)
        tokens = torch.from_numpy(self.walk(tok0.numpy(), choices.numpy()))
        return {"tokens": tokens.to(self.device),
                "loss_mask": torch.ones((self.batch, self.seq),
                                        dtype=torch.float32, device=self.device)}

    # -- DataSource protocol (example-level, CPU tensors) ---------------
    def shard_lengths(self) -> Tuple[int, ...]:
        per = self.epoch_examples // self.n_shards
        return (per,) * self.n_shards

    def read(self, shard: int, start: int, count: int) -> Dict[str, torch.Tensor]:
        """Examples ``first .. first + count - 1`` of the chain, example
        ``j`` keyed by ``fold_in(fold_in(PRNGKey(seed), 2**31 - 1), j)``
        (a domain disjoint from ``batch_at``'s), then split into a start
        token and ``seq`` branch choices, as the JAX package draws them
        (it maps the same per-key draws over the examples)."""
        check_read_range(self.shard_lengths(), shard, start, count)
        first = shard * (self.epoch_examples // self.n_shards) + start
        base = prng.fold_in(prng.PRNGKey(self.seed), 2**31 - 1)
        tok0 = np.empty(count, np.int32)
        choices = np.empty((count, self.seq), np.int32)
        for i in range(count):
            k0, k1 = prng.split(prng.fold_in(base, first + i))
            tok0[i] = int(prng.randint(k0, (), 0, self.vocab))
            choices[i] = prng.randint(k1, (self.seq,), 0, self.branching).numpy()
        return {"tokens": torch.from_numpy(self.walk(tok0, choices)),
                "loss_mask": torch.ones((count, self.seq), dtype=torch.float32)}

    def optimal_loss(self) -> float:
        """Entropy of the chain = log(branching) nats (distinct successors
        assumed; collisions make this an upper bound)."""
        return float(np.log(self.branching))


MU_SEED = 12345     # class means are a fixed property of the task, shared
                    # by every split — `seed` only draws samples


def synthetic_images(n: int, seed: int = 0, n_classes: int = 10,
                     image_size: int = 32, noise: float = 12.0):
    """CIFAR proxy: class-conditional images with SMOOTH (low-frequency)
    class means — x = mu_y + noise * N(0, 1), normalized to unit variance
    — as (x float32 (n, H, W, 3), y int32 (n,)) CPU tensors, bitwise the
    JAX package's arrays (numpy computes x in float64 after the
    normalisation; both round it to float32 once)."""
    rng_mu = np.random.RandomState(MU_SEED)
    coarse = rng_mu.randn(n_classes, image_size // 8, image_size // 8, 3)
    mus = np.kron(coarse, np.ones((1, 8, 8, 1))).astype(np.float32)
    rng = np.random.RandomState(seed)
    y = rng.randint(0, n_classes, size=(n,))
    x = mus[y] + noise * rng.randn(n, image_size, image_size, 3).astype(np.float32)
    x = x / np.sqrt(1.0 + noise ** 2)          # unit-ish variance
    return (torch.from_numpy(np.asarray(x, np.float32)),
            torch.from_numpy(np.asarray(y, np.int32)))


def synthetic_images_source(n: int, seed: int = 0,
                            shard_size: Optional[int] = None,
                            **kw) -> MemorySource:
    """The Table-2 image proxy as a sharded ``DataSource`` (fields
    ``x``/``y``), ready for the ``StreamingLoader`` or the data packer."""
    x, y = synthetic_images(n, seed=seed, **kw)
    return MemorySource({"x": x, "y": y}, shard_size=shard_size)
