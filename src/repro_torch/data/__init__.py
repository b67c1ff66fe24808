"""Data pipeline — deterministic, shard-aware, checkpointable: the port's
own copy of ``repro.data`` (numpy only; batches are numpy arrays, which the
train step moves to its device).  ``SyntheticLM`` draws from numpy's
``default_rng`` exactly as the reference does, so its batches equal the
reference's bit for bit.

Two sources with one iterator interface:
  * ``SyntheticLM``     — seeded synthetic token stream (markov-ish structure
                          so models can actually learn; used by the QAT
                          examples and tests).
  * ``MemmapCorpus``    — a flat binary token file (np.memmap), the
                          production path: O(1) open, sharded strided reads.

Sharding: each (host, data-shard) reads a disjoint strided slice — iterator
state is a single ``step`` counter, so checkpoint/restore is exact and
resuming on a different shard count re-partitions deterministically
(elastic restart).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LoaderState:
    step: int = 0


class SyntheticLM:
    """Deterministic synthetic LM stream with learnable structure:
    token_{t+1} = (a * token_t + b + noise) % vocab  with per-sequence (a, b)."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 shard: int = 0, num_shards: int = 1, seed: int = 0):
        assert global_batch % num_shards == 0
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = global_batch // num_shards
        self.shard = shard
        self.num_shards = num_shards
        self.seed = seed
        self.state = LoaderState()

    def __iter__(self):
        return self

    def _batch_at(self, step: int):
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.shard)
        a = rng.integers(1, 8, (self.batch, 1))
        b = rng.integers(0, self.vocab, (self.batch, 1))
        t0 = rng.integers(0, self.vocab, (self.batch, 1))
        toks = [t0]
        for _ in range(self.seq_len - 1):
            nxt = (a * toks[-1] + b) % self.vocab
            flip = rng.random((self.batch, 1)) < 0.05
            rand = rng.integers(0, self.vocab, (self.batch, 1))
            toks.append(np.where(flip, rand, nxt))
        tokens = np.concatenate(toks, axis=1).astype(np.int32)
        return {"tokens": tokens, "labels": tokens}

    def __next__(self):
        batch = self._batch_at(self.state.step)
        self.state.step += 1
        return batch

    # checkpointable iterator state
    def state_dict(self):
        return {"step": self.state.step}

    def load_state_dict(self, d):
        self.state.step = int(d["step"])


class MemmapCorpus:
    """Flat int32 token file; strided disjoint reads per shard."""

    def __init__(self, path: str, seq_len: int, global_batch: int,
                 shard: int = 0, num_shards: int = 1):
        assert global_batch % num_shards == 0
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.seq_len = seq_len
        self.batch = global_batch // num_shards
        self.shard = shard
        self.num_shards = num_shards
        self.n_seqs = len(self.tokens) // seq_len
        self.state = LoaderState()

    @staticmethod
    def write(path: str, tokens: np.ndarray):
        np.asarray(tokens, np.int32).tofile(path)

    def __iter__(self):
        return self

    def __next__(self):
        rows = []
        base = self.state.step * self.batch * self.num_shards \
            + self.shard * self.batch
        for i in range(self.batch):
            seq_i = (base + i) % self.n_seqs
            rows.append(self.tokens[seq_i * self.seq_len:
                                    (seq_i + 1) * self.seq_len])
        self.state.step += 1
        arr = np.stack(rows).astype(np.int32)
        return {"tokens": arr, "labels": arr}

    def state_dict(self):
        return {"step": self.state.step}

    def load_state_dict(self, d):
        self.state.step = int(d["step"])
