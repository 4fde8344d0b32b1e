"""Synthetic packed-token data pipeline.

Generates document streams with a Zipfian token distribution and packs them
into fixed-length training sequences with cross-document attention reset
omitted (standard packing). Deterministic per (seed, step) so multi-host
shards stay consistent without communication.
"""
from __future__ import annotations

import numpy as np


class PackedTokenDataset:
    def __init__(self, vocab_size: int, seq_len: int, *, seed: int = 0,
                 mean_doc_len: int = 512, zipf_a: float = 1.2):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.seed = seed
        self.mean_doc_len = mean_doc_len
        self.zipf_a = zipf_a

    def _doc(self, rng: np.random.Generator) -> np.ndarray:
        n = max(8, int(rng.exponential(self.mean_doc_len)))
        toks = rng.zipf(self.zipf_a, size=n)
        return np.clip(toks, 1, self.vocab_size - 1).astype(np.int32)

    def batch(self, step: int, batch_size: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        rows = []
        for _ in range(batch_size):
            buf: list[np.ndarray] = []
            total = 0
            while total < self.seq_len + 1:
                d = self._doc(rng)
                buf.append(d)
                total += len(d)
            row = np.concatenate(buf)[: self.seq_len + 1]
            rows.append(row)
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}
