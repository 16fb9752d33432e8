"""Deterministic synthetic-corpus data pipeline (``repro.data.pipeline`` twin).

Produces a learnable token stream (a mixture of periodic n-gram patterns over
the vocab) so smoke training shows a real, reproducible loss decrease.  The
pipeline is: (a) seeded and restartable from any step (checkpoint stores only
the step counter), (b) host-shardable — each data-parallel host slices its
rows deterministically, (c) allocation-free until a batch is requested.
numpy only: a batch equals the JAX package's, element for element, for the
same (seed, step, host).
"""
from __future__ import annotations

import numpy as np


class SyntheticLMDataset:
    def __init__(self, vocab: int, seq_len: int, *, seed: int = 0,
                 n_patterns: int = 64, order: int = 3):
        self.vocab = vocab
        self.seq_len = seq_len
        self.seed = seed
        rng = np.random.default_rng(seed)
        # order-k Markov transition table: next token is a deterministic
        # function of the previous `order` tokens plus light noise
        self.table = rng.integers(0, vocab, size=(n_patterns,), dtype=np.int32)
        self.order = order
        self.n_patterns = n_patterns

    def _gen(self, rng: np.random.Generator, batch: int) -> np.ndarray:
        toks = np.empty((batch, self.seq_len + 1), dtype=np.int32)
        toks[:, : self.order] = rng.integers(
            0, self.vocab, size=(batch, self.order))
        noise = rng.random((batch, self.seq_len + 1)) < 0.05
        rand = rng.integers(0, self.vocab, size=(batch, self.seq_len + 1))
        for t in range(self.order, self.seq_len + 1):
            key = toks[:, t - self.order: t].sum(axis=1) % self.n_patterns
            nxt = self.table[key]
            toks[:, t] = np.where(noise[:, t], rand[:, t], nxt)
        return toks

    def batch(self, step: int, batch_size: int, *, host_id: int = 0,
              n_hosts: int = 1):
        """Batch for a global step; deterministic in (seed, step, host)."""
        if batch_size % n_hosts:
            raise ValueError(f"batch {batch_size} does not split over {n_hosts} hosts")
        local = batch_size // n_hosts
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 97 + host_id)
        toks = self._gen(rng, local)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_batches(dataset: SyntheticLMDataset, batch_size: int, steps: int,
                 start_step: int = 0, host_id: int = 0, n_hosts: int = 1):
    for s in range(start_step, start_step + steps):
        yield s, dataset.batch(s, batch_size, host_id=host_id,
                               n_hosts=n_hosts)
