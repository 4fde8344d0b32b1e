"""Host plan of the decode kernels' split over keys (flash-decoding).

A decode step gives each (sequence, kv head) one query (or a few), so one
block per pair leaves most of the H100's 132 SMs idle while it walks a long
context tile after tile. The decode kernels (``csrc/decode_split.cuh``)
cut each row's key range ``[lo, hi)`` into ``n_split`` slices of ``chunk``
keys, one block each, and merge the slices' partial softmax states in a
second launch. The plan is pure Python on host integers: it never reads a
device tensor, so it costs no synchronisation.
"""
from __future__ import annotations

TILE = 64              # keys per shared-memory tile of the kernels
TARGET_BLOCKS = 264    # about two blocks per SM of the H100's 132
MIN_SPLIT_KEYS = 256   # four tiles a slice, so the merge stays cheap


def plan(rows: int, lo: int, hi: int, unit: int) -> tuple[int, int]:
    """``(n_split, chunk)`` for ``rows`` (sequence, kv head) pairs over keys
    ``[lo, hi)``: enough slices that ``rows * n_split`` reaches about
    ``TARGET_BLOCKS``, none shorter than ``MIN_SPLIT_KEYS`` (but at least
    one), each a multiple of ``unit`` keys; the last may be shorter."""
    if rows < 1 or hi <= lo or unit < 1:
        raise ValueError(f"split plan: rows={rows}, keys [{lo}, {hi}), "
                         f"unit={unit}")
    n_keys = hi - lo
    want = -(-TARGET_BLOCKS // rows)
    n = max(1, min(want, n_keys // MIN_SPLIT_KEYS))
    chunk = -(-n_keys // n)
    chunk = -(-chunk // unit) * unit
    return -(-n_keys // chunk), chunk


def ranges(lo: int, hi: int, n_split: int, chunk: int) -> list[tuple[int, int]]:
    """The key slices ``[start, end)`` of a plan, in order."""
    return [(lo + s * chunk, min(hi, lo + (s + 1) * chunk))
            for s in range(n_split)]


def record_floats(hd: int) -> int:
    """f32 words of one partial state (O over hd rounded up to even, m,
    l): the kernels' layout of the scratch."""
    return (hd + 1) // 2 * 2 + 2
