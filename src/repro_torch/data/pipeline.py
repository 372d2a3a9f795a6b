"""Deterministic, shardable, exactly-resumable synthetic token pipeline.

Counterpart: ``repro/data/pipeline.py``, copied as it is (numpy only), so a
batch is bit-equal to the reference's at every (seed, step, shard).

Every batch is a pure function of (seed, step) — a counter-based generator,
not a stateful stream — so:

* restart-from-checkpoint replays *no* sample twice and skips none: the
  training loop just continues at ``step+1`` (fault-tolerance requirement);
* each data shard materializes only its slice (host-parallel loading);
* no filesystem dependency (the container has no corpora); swapping in a real
  corpus only means replacing ``_tokens_for``.

The token stream is a stationary Markov-ish process (mixed linear
congruential + n-gram structure) so small models actually have something
learnable for the end-to-end example, rather than uniform noise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234


class SyntheticTokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _tokens_for(self, step: int, index: int) -> np.ndarray:
        """One (seq_len+1,) sample, deterministic in (seed, step, index)."""
        c = self.cfg
        rng = np.random.Generator(np.random.Philox(
            key=c.seed, counter=[0, 0, step, index]))
        # learnable structure: token_{t+1} = (a * token_t + b + noise) % V
        # (a, b) depend only on the sample index, so the mapping is stable
        # across steps and the loss visibly falls within tens of steps
        a = 31 + (index % 7)
        b = (index * 97 + c.seed) % c.vocab
        toks = np.empty(c.seq_len + 1, np.int64)
        toks[0] = rng.integers(0, c.vocab)
        noise = rng.integers(0, 5, size=c.seq_len)
        for t in range(c.seq_len):
            toks[t + 1] = (a * toks[t] + b + noise[t]) % c.vocab
        return toks

    def global_batch_at(self, step: int) -> Dict[str, np.ndarray]:
        return self.shard_batch_at(step, 0, 1)

    def shard_batch_at(self, step: int, shard: int, n_shards: int
                       ) -> Dict[str, np.ndarray]:
        """The ``shard``-th of ``n_shards`` slices of the global batch at
        ``step`` (batch dim is the sharded dim)."""
        c = self.cfg
        assert c.global_batch % n_shards == 0
        per = c.global_batch // n_shards
        rows = [self._tokens_for(step, shard * per + i) for i in range(per)]
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1].astype(np.int32),
                "labels": arr[:, 1:].astype(np.int32)}
