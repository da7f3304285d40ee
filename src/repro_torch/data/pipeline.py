"""Deterministic, shardable token pipeline.

Two sources:

* :class:`SyntheticLM` — seeded Zipf-ish token stream with local structure
  (learnable bigram bias) so smoke-training shows a real loss drop;
* :class:`PackedFileDataset` — flat uint16/uint32 token files (the
  production path), memory-mapped and sharded by (host, data-axis) with
  deterministic resume (step -> offset is pure arithmetic, so restoring a
  checkpoint replays the exact batch order — required for fault-tolerant
  restarts).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    shard: int = 0        # this host's data-parallel index
    n_shards: int = 1


class SyntheticLM:
    """Deterministic synthetic LM data with predictable structure."""

    def __init__(self, vocab_size: int, seq_len: int, batch_per_shard: int,
                 shard: ShardInfo = ShardInfo(), seed: int = 1234):
        self.vocab = vocab_size
        self.seq_len = seq_len
        self.batch = batch_per_shard
        self.shard = shard
        self.seed = seed
        # fixed random bigram table: next token = f(prev) with noise
        rng = np.random.default_rng(seed)
        self.bigram = rng.integers(0, vocab_size, size=(vocab_size,))

    def batch_at(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed, step, self.shard.shard))
        B, S = self.batch, self.seq_len
        toks = np.empty((B, S), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=B)
        noise = rng.random((B, S)) < 0.15
        rand = rng.integers(0, self.vocab, size=(B, S))
        for t in range(1, S):
            nxt = self.bigram[toks[:, t - 1]]
            toks[:, t] = np.where(noise[:, t], rand[:, t], nxt)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1        # masked
        return toks, labels

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PackedFileDataset:
    """Flat binary token file, deterministic strided sharding."""

    def __init__(self, path: str, vocab_size: int, seq_len: int,
                 batch_per_shard: int, shard: ShardInfo = ShardInfo(),
                 dtype=np.uint16):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.vocab = vocab_size
        self.seq_len = seq_len
        self.batch = batch_per_shard
        self.shard = shard
        self.n_windows = (len(self.tokens) - 1) // seq_len

    def batch_at(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        B, S = self.batch, self.seq_len
        base = (step * self.shard.n_shards + self.shard.shard) * B
        idx = (base + np.arange(B)) % self.n_windows
        toks = np.stack([self.tokens[i * S:(i + 1) * S] for i in idx])
        labels = np.stack([self.tokens[i * S + 1:(i + 1) * S + 1] for i in idx])
        return toks.astype(np.int32), labels.astype(np.int32)

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def write_packed_file(path: str, tokens: np.ndarray, dtype=np.uint16) -> None:
    np.asarray(tokens, dtype).tofile(path)
