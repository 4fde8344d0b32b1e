"""What a served step asks of the card: operations and bytes, counted by
the benchmark from the rows each step ran, never read from the program.

* ``decode_work`` and ``prefill_work`` are frozen copies of the bytes and
  operations that ``chip_smoke.py`` (commit 1a285e9, ``check_decode`` and
  ``check_prefill``) counts for one call of the paged decode and the paged
  prefill kernel: the live K/V read once, q read and the output written
  once, the block table and the lengths; two products over the visible
  (query, key) pairs.
* ``bucket`` and ``table_width`` are frozen copies of the executor's call
  geometry (``ModelExecutor._bucket`` and ``_bucket_pages``, commit
  1a285e9): a call's batch, chunk and block table are padded to powers of
  two, and the kernel is handed those shapes.
* ``step_flops`` counts a step's model operations: every linear layer for
  every token computed, attention over the visible pairs, and the LM head
  for the rows that emit a token.

H100 SXM peaks (NVIDIA's data sheet, dense, 700 W): bf16 tensor cores
989 TFLOP/s, HBM3 3.35 TB/s.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bucket(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def table_width(live_pages: int, max_len: int, page: int) -> int:
    """Block-table width of a call whose widest row holds ``live_pages``."""
    return min(bucket(max(live_pages, 1)), -(-max_len // page))


def decode_work(lengths, h, kv, hd, batch, table):
    """(bytes, flops) of one paged decode call: rows of ``lengths`` keys
    (after this step's write), a q of ``batch`` rows, a block table of
    ``table`` pages a row."""
    live = sum(lengths)
    bytes_ = (live * kv * hd * 2 * 2 + 2 * batch * h * hd * 2
              + batch * table * 4 + batch * 4)
    flops = 4 * live * h * hd
    return bytes_, flops


def prefill_work(q_start, new_lens, Sq, h, kv, hd, batch, table):
    """(bytes, flops) of one paged prefill call: row i's ``new_lens[i]``
    queries at positions ``q_start[i]``.., a q of ``batch`` x ``Sq``."""
    live = sum(s + n for s, n in zip(q_start, new_lens))
    pairs = sum(n * s + n * (n + 1) // 2 for s, n in zip(q_start, new_lens))
    bytes_ = (live * kv * hd * 2 * 2 + 2 * batch * Sq * h * hd * 2
              + batch * table * 4 + 2 * batch * 4)
    flops = 4 * pairs * h * hd
    return bytes_, flops


def bound_s(bytes_, flops) -> float:
    """The least time the card could take: the larger of the two."""
    return max(bytes_ / PEAK_BYTES, flops / PEAK_FLOPS)


def linear_params(cfg: dict) -> int:
    """Weights one token multiplies through in one decoder layer."""
    D, H, KV = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg.get("head_dim") or D // H
    return D * (H + 2 * KV) * hd + H * hd * D + 3 * D * cfg["d_ff"]


def step_flops(cfg: dict, prefill_rows, decode_contexts, emitting: int):
    """Model operations of one step. ``prefill_rows``: (start, n) per
    chunk; ``decode_contexts``: keys each decode row sees (its own
    included); ``emitting``: rows whose LM head output is a served
    token."""
    D, H = cfg["d_model"], cfg["num_heads"]
    hd = cfg.get("head_dim") or D // H
    L = cfg["num_layers"]
    tokens = sum(n for _s, n in prefill_rows) + len(decode_contexts)
    pairs = sum(n * s + n * (n + 1) // 2 for s, n in prefill_rows) + \
        sum(decode_contexts)
    return (L * (2 * tokens * linear_params(cfg) + 4 * pairs * H * hd)
            + 2 * emitting * D * cfg["vocab_size"])
