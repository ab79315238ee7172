"""Deterministic synthetic language data (no datasets ship offline).

A port of ``repro.data.synthetic.SyntheticLM``'s batch stream: token
sequences from a fixed random bigram chain with controllable branching,
a learnable distribution (its entropy is log(branching) nats).

The successor table comes from ``np.random.RandomState(seed)`` and each
batch's start tokens and branch choices from ``repro_torch.prng`` keyed
as the JAX package keys them, so batch ``i`` is bitwise the JAX
package's batch ``i`` for the same seed.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import prng


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
        """Batch ``i`` of ``batch_size`` sequences, on ``device``: the
        draws of ``repro.data.synthetic.SyntheticLM.batch_at``."""
        k0, k1 = prng.split(prng.fold_in(prng.PRNGKey(self.seed), i))
        tok0 = prng.randint(k0, (self.batch,), 0, self.vocab)
        choices = prng.randint(k1, (self.batch, self.seq), 0, self.branching)
        tokens = torch.from_numpy(self.walk(tok0.numpy(), choices.numpy()))
        return {"tokens": tokens.to(self.device),
                "loss_mask": torch.ones((self.batch, self.seq),
                                        dtype=torch.float32, device=self.device)}
