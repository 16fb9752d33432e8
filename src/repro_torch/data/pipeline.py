"""Deterministic synthetic-corpus data pipeline (``repro.data.pipeline`` twin).

Produces a learnable token stream (a mixture of periodic n-gram patterns over
the vocab) so smoke training shows a real, reproducible loss decrease.  The
pipeline is: (a) seeded and restartable from any step (checkpoint stores only
the step counter), (b) host-shardable — each data-parallel host slices its
rows deterministically, (c) allocation-free until a batch is requested.
A token batch is made in numpy and equals the JAX package's, element for
element, for the same (seed, step, host).  ``pseudo_embeds`` makes a
frontend stub's input on the device instead.
"""
from __future__ import annotations

import numpy as np
import torch


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


def pseudo_embeds(batch: int, seq: int, d_model: int, *, seed: int, step: int, dtype,
                  device):
    """A frontend stub's input for one step: 0.02 * N(0, 1) of shape (batch,
    seq, d_model), drawn in f32 and rounded once to ``dtype``, from a
    ``torch.Generator`` on ``device`` seeded from (seed, step), so that a
    resumed run draws the same embeddings.  The JAX package draws its own
    through ``jax.random``, which torch cannot reproduce."""
    state = int(np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0])
    g = torch.Generator(device).manual_seed(state)
    x = torch.randn((batch, seq, d_model), generator=g, dtype=torch.float32, device=device)
    return (0.02 * x).to(dtype)


def make_batches(dataset: SyntheticLMDataset, batch_size: int, steps: int,
                 start_step: int = 0, host_id: int = 0, n_hosts: int = 1):
    for s in range(start_step, start_step + steps):
        yield s, dataset.batch(s, batch_size, host_id=host_id,
                               n_hosts=n_hosts)
