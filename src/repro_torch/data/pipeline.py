"""Deterministic synthetic token streams (numpy copy of the sources of
``repro/data/pipeline.py``, which imports jax, so nothing of it is imported
here).

  * ``SyntheticLM``: hash-based tokens (uniform), for throughput runs.
  * ``ZipfNgramLM``: a learnable 2-gram language over a Zipf vocabulary, so
    a training run shows a real loss curve.

``batch_at(step)`` is deterministic in (seed, step) and equal to the
reference's (pinned by ``tests/test_torch_train.py``).  The reference's
prefetching ``ShardedLoader`` has no counterpart: ``launch/train.run`` cuts
each global batch to its data rank's rows and moves them with
:func:`to_device`.
"""

from __future__ import annotations

import numpy as np
import torch


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


class SyntheticLM:
    def __init__(self, vocab: int, seq_len: int, global_batch: int, seed: int = 0):
        self.vocab, self.seq, self.batch, self.seed = vocab, seq_len, global_batch, seed

    def batch_at(self, step: int) -> dict:
        r = _rng(self.seed, step)
        tok = r.integers(0, self.vocab, (self.batch, self.seq + 1), dtype=np.int32)
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


class ZipfNgramLM:
    """2-gram LM: next ~ P(.|prev) with per-prev Zipf permutations."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int, seed: int = 0):
        self.vocab, self.seq, self.batch, self.seed = vocab, seq_len, global_batch, seed
        r = _rng(seed, 0)
        self.shift = r.integers(1, vocab, (vocab,), dtype=np.int64)

    def batch_at(self, step: int) -> dict:
        r = _rng(self.seed, step + 1)
        b, s, v = self.batch, self.seq, self.vocab
        # zipf-ish ranks; next token = (prev * a + rank-sample) mod V
        ranks = np.minimum(
            r.zipf(1.3, (b, s + 1)).astype(np.int64), v - 1)
        tok = np.empty((b, s + 1), np.int64)
        tok[:, 0] = r.integers(0, v, (b,))
        for t in range(1, s + 1):
            tok[:, t] = (self.shift[tok[:, t - 1]] + ranks[:, t]) % v
        tok = tok.astype(np.int32)
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def to_device(host: dict, device) -> dict:
    """A host batch of int arrays as int64 tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).long().to(device)
            for k, v in host.items()}

