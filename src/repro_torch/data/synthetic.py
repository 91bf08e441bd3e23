"""Deterministic synthetic LM data (copy of ``repro/data/synthetic.py``):
a mixture of Zipfian unigrams and copy patterns so a real model can
visibly *learn* (loss drops below unigram entropy when it exploits the copy
structure) — used by the training launcher and integration tests.
"""
from __future__ import annotations

import numpy as np


class SyntheticLM:
    def __init__(self, vocab: int, seq_len: int, seed: int = 0,
                 copy_period: int = 8):
        self.vocab = vocab
        self.seq_len = seq_len
        self.copy_period = copy_period
        self.rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        self.probs = (1 / ranks) / np.sum(1 / ranks)

    def batch(self, n: int) -> dict[str, np.ndarray]:
        S = self.seq_len
        toks = self.rng.choice(self.vocab, size=(n, S + 1), p=self.probs)
        # every copy_period-th token repeats the token copy_period before it
        for off in range(self.copy_period, S + 1, self.copy_period):
            toks[:, off] = toks[:, off - self.copy_period]
        toks = toks.astype(np.int32)
        return {
            "tokens": toks[:, :-1],
            "targets": toks[:, 1:],
            "mask": np.ones((n, S), np.float32),
        }

    def iterator(self, batch_size: int):
        while True:
            yield self.batch(batch_size)
