"""Deterministic, shardable, RESUMABLE token pipeline.

Counterpart of ``repro.data.tokens``: host numpy iterators, with the cell
ids taken through the port's ``zorder.cell_ids`` on the CPU.
Trajectories are tokenized as Morton cell sequences (zorder.py) — the
paper-native way to turn spatial data into LM training data — plus a
synthetic-corpus mode for the generic archs.  The iterator state is two
integers (epoch, cursor) checkpointed with the train state, so restarts
(including elastic restarts on a different data-shard count) resume exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.core import zorder

BOS = 0
EOS = 1
SPECIALS = 64


@dataclasses.dataclass
class PipelineState:
    epoch: int = 0
    cursor: int = 0

    def as_dict(self):
        return {"epoch": self.epoch, "cursor": self.cursor}

    @classmethod
    def from_dict(cls, d):
        return cls(int(d["epoch"]), int(d["cursor"]))


def tokenize_trajectory(pts: np.ndarray, lo, hi, theta: int) -> np.ndarray:
    """Trajectory -> BOS + Morton cell ids (+SPECIALS offset) + EOS.
    ``lo`` and ``hi`` may be numpy arrays or tensors on any device."""
    def host(x):
        return torch.as_tensor(x, dtype=torch.float32).cpu()

    ids = zorder.cell_ids(host(pts), host(lo), host(hi), theta).numpy()
    # collapse runs (vehicle lingering in one cell)
    keep = np.ones(len(ids), bool)
    keep[1:] = ids[1:] != ids[:-1]
    ids = ids[keep] + SPECIALS
    return np.concatenate([[BOS], ids, [EOS]]).astype(np.int32)


class TokenPipeline:
    """Packs documents into fixed-length (tokens, labels) batches.

    Deterministic given (docs, seq_len, batch, seed); `state` makes it
    resumable; `shard(i, n)` restricts to a host shard for multi-host input
    feeding (each host feeds its slice of the global batch).
    """

    def __init__(self, docs: list[np.ndarray], seq_len: int, batch: int,
                 *, seed: int = 0, state: PipelineState | None = None):
        self.docs = docs
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed
        self.state = state or PipelineState()
        self._stream = self._make_stream()

    def _order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(len(self.docs))

    def _make_stream(self) -> Iterator[np.ndarray]:
        """Infinite token stream, starting at the checkpointed cursor."""
        while True:
            order = self._order(self.state.epoch)
            while self.state.cursor < len(order):
                doc = self.docs[order[self.state.cursor]]
                self.state.cursor += 1
                yield doc
            self.state.epoch += 1
            self.state.cursor = 0

    def next_batch(self) -> dict:
        need = self.batch * (self.seq_len + 1)
        buf = np.empty((0,), np.int32)
        while buf.size < need:
            buf = np.concatenate([buf, next(self._stream)])
        buf = buf[:need].reshape(self.batch, self.seq_len + 1)
        return {"tokens": buf[:, :-1].copy(),
                "labels": buf[:, 1:].copy()}


def synthetic_corpus(n_docs: int, vocab: int, *, seed: int = 0,
                     doc_len=(64, 512)) -> list[np.ndarray]:
    """Zipf-ish synthetic documents for the non-spatial archs."""
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n_docs):
        n = int(rng.integers(*doc_len))
        toks = rng.zipf(1.3, n) % (vocab - SPECIALS) + SPECIALS
        docs.append(np.concatenate([[BOS], toks, [EOS]]).astype(np.int32))
    return docs
