"""Sharded, deterministic, *resumable* training-data pipeline.

Fault-tolerance contract: the pipeline's full position is captured by
``PipelineState`` (epoch, step-within-epoch, rng seed) — a tiny record
checkpointed alongside model state, so a restarted (or re-scaled) job
resumes mid-epoch with the exact same global batch sequence.

Sharding: each data-parallel rank draws the same permutation (seeded) and
takes its slice of every global batch — no inter-host coordination, which
is what survives elastic rescale: a restore onto a different dp_size just
re-slices the same global sequence.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PipelineState:
    epoch: int = 0
    index: int = 0
    seed: int = 0

    def to_dict(self) -> dict:
        return {"epoch": self.epoch, "index": self.index, "seed": self.seed}

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineState":
        return cls(**d)


class DataPipeline:
    """Packs token streams into (batch, seq) next-token-prediction batches."""

    def __init__(self, token_docs: list[list[int]], *, seq_len: int,
                 global_batch: int, seed: int = 0,
                 dp_rank: int = 0, dp_size: int = 1):
        assert global_batch % dp_size == 0
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // dp_size
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        self.state = PipelineState(seed=seed)
        # pack all docs into one ring of tokens (document-boundary EOS kept)
        stream = []
        for doc in token_docs:
            stream.extend(doc)
        need = seq_len + 1
        n_seqs = max(len(stream) // need, 1)
        stream = (stream * (need * 2 // max(len(stream), 1) + 1)
                  if len(stream) < need else stream)
        n_seqs = max(len(stream) // need, 1)
        self._seqs = np.asarray(
            stream[: n_seqs * need], dtype=np.int32).reshape(n_seqs, need)

    @property
    def steps_per_epoch(self) -> int:
        return max(len(self._seqs) // self.global_batch, 1)

    def _perm(self, epoch: int) -> np.ndarray:
        rng = np.random.RandomState((self.state.seed * 9973 + epoch) % 2**31)
        return rng.permutation(len(self._seqs))

    def next_batch(self) -> dict:
        st = self.state
        perm = self._perm(st.epoch)
        start = (st.index * self.global_batch) % len(self._seqs)
        idx = [perm[(start + j) % len(self._seqs)]
               for j in range(self.global_batch)]
        # local slice for this dp rank
        lo = self.dp_rank * self.local_batch
        rows = self._seqs[idx[lo: lo + self.local_batch]]
        st.index += 1
        if st.index >= self.steps_per_epoch:
            st.index = 0
            st.epoch += 1
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    # -- checkpoint integration --
    def snapshot(self) -> dict:
        return self.state.to_dict()

    def restore(self, d: dict) -> None:
        self.state = PipelineState.from_dict(d)
