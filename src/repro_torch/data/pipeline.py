"""Deterministic, checkpointable data pipeline (numpy only).

The port's copy of ``repro.data.pipeline``: the same Philox keys give the
same batches bit for bit, so a run of the port and one of the JAX package
see one token stream.

Fault-tolerance contract: a batch is a pure function of (seed, step, shard),
so restoring ``DataState.step`` after a failure replays the exact stream —
no data loss or duplication across restarts.

Two sources:
- ``SyntheticTokens``: Philox-keyed synthetic LM tokens (offline container).
- ``MemmapTokens``: packed binary token file (np.memmap), sharded striding.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class DataState:
    seed: int
    step: int

    def to_dict(self):
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_dict(cls, d):
        return cls(seed=int(d["seed"]), step=int(d["step"]))


class SyntheticTokens:
    """Zipf-ish synthetic token stream; batch = f(seed, step, shard)."""

    def __init__(self, vocab: int, batch: int, seq: int, *, seed: int = 0,
                 shard: int = 0, num_shards: int = 1):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.state = DataState(seed=seed, step=0)
        self.shard, self.num_shards = shard, num_shards

    def batch_at(self, step: int):
        rng = np.random.default_rng(
            np.random.Philox(key=[(self.state.seed << 16) ^ self.shard, step])
        )
        # heavy-tailed unigram stream with short-range repetition structure
        base = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        tokens = (base % (self.vocab - 2)) + 1
        rep = rng.random((self.batch, self.seq + 1)) < 0.2
        tokens = np.where(rep, np.roll(tokens, 1, axis=1), tokens)
        return {
            "tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32),
        }

    def __next__(self):
        b = self.batch_at(self.state.step)
        self.state.step += 1
        return b


class MemmapTokens:
    """Packed int32 token file; deterministic strided sampling per step."""

    def __init__(self, path: str, batch: int, seq: int, *, seed: int = 0,
                 shard: int = 0, num_shards: int = 1):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.batch, self.seq = batch, seq
        self.state = DataState(seed=seed, step=0)
        self.shard, self.num_shards = shard, num_shards
        self.n_windows = max((len(self.tokens) - 1) // seq, 1)

    def batch_at(self, step: int):
        rng = np.random.default_rng(
            np.random.Philox(key=[(self.state.seed << 16) ^ self.shard ^ (1 << 30), step])
        )
        idx = rng.integers(0, self.n_windows, self.batch)
        starts = idx * self.seq
        tok = np.stack([self.tokens[s:s + self.seq + 1] for s in starts])
        return {"tokens": tok[:, :-1].astype(np.int32),
                "labels": tok[:, 1:].astype(np.int32)}

    def __next__(self):
        b = self.batch_at(self.state.step)
        self.state.step += 1
        return b


def make_dataset(kind: str, *, vocab: int, batch: int, seq: int,
                 path: Optional[str] = None, seed: int = 0):
    if kind == "synthetic":
        return SyntheticTokens(vocab, batch, seq, seed=seed)
    if kind == "memmap":
        if not path:
            raise ValueError("memmap dataset needs --data-path")
        return MemmapTokens(path, batch, seq, seed=seed)
    raise ValueError(f"unknown dataset kind {kind!r}")
