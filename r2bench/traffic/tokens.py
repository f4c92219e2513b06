"""Token streams from the seed: a frozen copy of ``repro_torch.data``'s
``SyntheticTokens`` (a Zipf-free bigram language with a fixed random table of
32 likely successors a token and 10% noise), so that the batches a cell trains
on stay the same when the program's data module changes."""

from __future__ import annotations

import numpy as np


class BigramTokens:
    """Token ids below ``vocab``; ``seed`` fixes the successor table and,
    with a step or request index, every draw."""

    def __init__(self, vocab: int, seed: int, k: int = 32):
        self.vocab, self.seed = vocab, seed
        self.successors = np.random.default_rng(seed).integers(0, vocab, size=(vocab, min(vocab, k)))

    def _walk(self, rng: np.random.Generator, rows: int, length: int) -> np.ndarray:
        v, k = self.vocab, self.successors.shape[1]
        toks = np.empty((rows, length), np.int64)
        toks[:, 0] = rng.integers(0, v, size=rows)
        choice = rng.integers(0, k, size=(rows, length))
        mix = rng.random((rows, length)) < 0.9
        noise = rng.integers(0, v, size=(rows, length))
        for t in range(length - 1):
            nxt = self.successors[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(mix[:, t], nxt, noise[:, t])
        return toks

    def batch(self, step: int, rows: int, seq_len: int) -> dict[str, np.ndarray]:
        """Training step ``step``'s global batch: ``tokens`` and the next
        token of each as ``labels``, (rows, seq_len) each."""
        toks = self._walk(np.random.default_rng((self.seed, 0, step)), rows, seq_len + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def prompt(self, index: int, length: int) -> np.ndarray:
        """Request ``index``'s prompt of ``length`` tokens."""
        return self._walk(np.random.default_rng((self.seed, 1, index)), 1, length)[0]
