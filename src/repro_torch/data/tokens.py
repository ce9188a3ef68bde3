"""Synthetic LM token pipeline for the training substrate: the port's copy of
the JAX package's ``data/tokens.py`` (numpy only, so the batches are byte
for byte the reference's).

Deterministic, dependency-free corpus: a Zipf unigram distribution modulated by
an order-1 Markov structure so that a model can actually reduce loss.  The
iterator yields fixed-shape (tokens, labels) batches — the host-side
analogue of a tf.data/grain pipeline, with shard-aware slicing for
multi-host use.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_streams: int = 64          # markov "topics"
    shard_index: int = 0         # this host's data shard
    shard_count: int = 1

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = min(self.vocab_size, 4096)  # active vocabulary head
        base = 1.0 / np.arange(1, v + 1) ** 1.1
        self._base = base / base.sum()
        self._v = v
        # per-stream multiplicative tilt, fixed across steps
        self._tilts = rng.random((self.n_streams, v)) ** 2
        self._step = 0

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.shard_count == 0
        return self.global_batch // self.shard_count

    def next_batch(self) -> tuple[np.ndarray, np.ndarray]:
        """Returns (tokens, labels) of shape (local_batch, seq_len) int32."""
        rng = np.random.default_rng(
            (self.seed, self._step, self.shard_index))
        self._step += 1
        b, s = self.local_batch, self.seq_len
        streams = rng.integers(self.n_streams, size=b)
        toks = np.empty((b, s + 1), dtype=np.int32)
        for i, st in enumerate(streams):
            p = self._base * self._tilts[st]
            p = p / p.sum()
            toks[i] = rng.choice(self._v, size=s + 1, p=p)
        return toks[:, :-1], toks[:, 1:]

    def __iter__(self):
        while True:
            yield self.next_batch()
