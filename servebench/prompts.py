"""The prompt's token ids, worked out again by the benchmark.

Frozen copy of the rule in ``ModelExecutor._prompt_tokens``
(``src/repro_torch/serving/executors.py`` at commit 1a285e9) with
``Request.content_chunks`` (``serving/request.py``): the program makes a
prompt's ids itself from the request's identity, so the reference has to
make the same ids from the same identity without asking the program.
"""
from __future__ import annotations

import zlib

import numpy as np


def content_chunks(rid: str, prompt_tokens: int, mm_units: int,
                   mm_hash: str | None, shared_prefix_id: str | None = None,
                   shared_prefix_tokens: int = 0) -> tuple:
    """The prompt as ``(content_id, tokens)`` segments: [shared system
    prefix][mm payload][private text]."""
    chunks, used = [], 0
    if shared_prefix_tokens > 0 and shared_prefix_id:
        n = min(shared_prefix_tokens, prompt_tokens)
        chunks.append((f"sys:{shared_prefix_id}", n))
        used += n
    if mm_units > 0 and used < prompt_tokens:
        cid = f"mm:{mm_hash}" if mm_hash else f"mm!{rid}"
        n = min(mm_units, prompt_tokens - used)
        chunks.append((cid, n))
        used += n
    if used < prompt_tokens:
        chunks.append((f"txt!{rid}", prompt_tokens - used))
    return tuple(chunks)


def _stream(key: str, n: int, vocab: int) -> np.ndarray:
    seed = zlib.crc32(key.encode()) & 0x7FFFFFFF
    return np.random.default_rng(seed).integers(1, vocab, size=n,
                                                dtype=np.int64)


def prompt_tokens(rid: str, chunks: tuple, vocab: int) -> np.ndarray:
    """int64 ids of the whole prompt."""
    if len(chunks) == 1 and chunks[0][0] == f"txt!{rid}":
        return _stream(rid, chunks[0][1], vocab)
    if not chunks:
        return np.zeros(0, np.int64)
    return np.concatenate([_stream(cid, n, vocab) for cid, n in chunks])
