"""Deterministic synthetic token pipeline with per-host sharding.

A numpy copy of ``repro/data/pipeline.py``: batch ``i`` is a pure function
of ``(seed, i)`` and is bit-identical to the reference's batch ``i`` for the
same seed.  It produces a structured pseudo-language (Zipf-distributed
unigrams with local n-gram correlations) so small-model training shows a
real, monotone loss drop; the stream is stateless-resumable, so
checkpoint/restart resumes identically mid-epoch, and host h of H reads
batch rows [h::H] of the same virtual stream.  Batches are numpy; the
trainer moves them to its device."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    zipf_a: float = 1.2


class SyntheticTokens:
    """Indexable deterministic stream of {"tokens","targets"} batches."""

    def __init__(self, dcfg: DataConfig) -> None:
        self.dcfg = dcfg
        if dcfg.global_batch % dcfg.num_hosts:
            raise ValueError(f"global_batch {dcfg.global_batch} is not a multiple of "
                             f"num_hosts {dcfg.num_hosts}")
        self.local_batch = dcfg.global_batch // dcfg.num_hosts
        # fixed Zipf-ish unigram table + a deterministic bigram shift table
        rng = np.random.default_rng(dcfg.seed)
        ranks = np.arange(1, dcfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** -dcfg.zipf_a
        self._probs = probs / probs.sum()
        self._shift = rng.integers(0, dcfg.vocab_size,
                                   size=dcfg.vocab_size, dtype=np.int64)

    def batch(self, index: int) -> dict:
        d = self.dcfg
        rng = np.random.default_rng(
            (d.seed * 1_000_003 + index) * 4096 + d.host_id)
        base = rng.choice(d.vocab_size, size=(self.local_batch, d.seq_len + 1),
                          p=self._probs)
        # 50% of positions copy a bigram-shifted version of the previous token
        # (learnable structure)
        prev = np.concatenate([base[:, :1], base[:, :-1]], axis=1)
        follow = self._shift[prev]
        mask = rng.random((self.local_batch, d.seq_len + 1)) < 0.5
        seq = np.where(mask, follow, base).astype(np.int32)
        return {"tokens": seq[:, :-1], "targets": seq[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1


def make_pipeline(vocab_size: int, seq_len: int, global_batch: int,
                  seed: int = 0, host_id: int = 0,
                  num_hosts: int = 1) -> SyntheticTokens:
    return SyntheticTokens(DataConfig(vocab_size, seq_len, global_batch, seed,
                                      host_id, num_hosts))
