"""Deterministic synthetic data pipeline.

Stateless by construction: batch(step) is a pure function of
(seed, step, shard), so resume-after-preemption needs NO data-loader state in
the checkpoint (skip-ahead = just ask for the right step), and every data
shard of a fleet generates exactly its slice.

Two sources:
* ``SyntheticTokens`` — uniform random tokens (dry-run/throughput shapes).
* ``MarkovTokens``    — tokens from a fixed sparse Markov chain: there is
  real structure to learn, so training loss visibly drops below the unigram
  entropy (used by the end-to-end driver / examples).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticTokens:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1):
        b = self.batch // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        return {"tokens": rng.integers(0, self.vocab, size=(b, self.seq_len),
                                       dtype=np.int32)}


@dataclasses.dataclass(frozen=True)
class MarkovTokens:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    branching: int = 4  # successors per state -> entropy ~= log(branching)

    def _table(self):
        rng = np.random.default_rng(self.seed)
        succ = rng.integers(0, self.vocab, size=(self.vocab, self.branching))
        return succ

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1):
        succ = self._table()
        b = self.batch // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed + 1, step, shard]))
        toks = np.empty((b, self.seq_len), dtype=np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=b)
        choices = rng.integers(0, self.branching, size=(b, self.seq_len))
        for t in range(1, self.seq_len):
            toks[:, t] = succ[toks[:, t - 1], choices[:, t]]
        return {"tokens": toks}

    @property
    def target_entropy(self) -> float:
        return float(np.log(self.branching))
