"""Deterministic synthetic language data (no datasets ship offline).

A port of ``repro.data.synthetic.SyntheticLM``'s batch stream: token
sequences from a fixed random bigram chain with controllable branching,
a learnable distribution (its entropy is log(branching) nats).

The successor table comes from ``np.random.RandomState(seed)`` exactly
as in the JAX package, so it is bitwise the same table.  The JAX
package draws each batch's start tokens and branch choices with
``jax.random``; the port draws them from a numpy ``Generator`` keyed by
(seed, batch index), so the two streams differ while each is a pure
function of (seed, i).  The parity tests hand the JAX package's batches
to both sides; ``walk`` is the shared chain walk.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


class SyntheticLM:
    """Bigram chain: the next token is uniform over ``branching``
    successors of the current one (table fixed by ``seed``)."""

    def __init__(self, vocab_size: int, seq_len: int, batch_size: int,
                 seed: int = 0, branching: int = 4,
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
        """Batch ``i`` of ``batch_size`` sequences, on ``device``."""
        rng = np.random.default_rng([self.seed, i])
        tok0 = rng.integers(0, self.vocab, self.batch, dtype=np.int32)
        choices = rng.integers(0, self.branching, (self.batch, self.seq),
                               dtype=np.int32)
        tokens = torch.from_numpy(self.walk(tok0, choices))
        return {"tokens": tokens.to(self.device),
                "loss_mask": torch.ones((self.batch, self.seq),
                                        dtype=torch.float32, device=self.device)}
