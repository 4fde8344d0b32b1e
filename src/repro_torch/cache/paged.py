"""Paged KV store: torch page pools + batched write/read ops per layer stack.

``PagedStackStore`` is the serving executor's batched container — the
paged KV of one *stack* of layers (one stage's block position), flattened
into one pool: tensors are ``(layers * pages_per_layer, page, KV, hd)`` and
layer ``l``'s page ``p`` lives at row ``l * pages_per_layer + p``. The
forward's per-layer index offsets reads/writes into the flat pool, so a
batched step touches only resident pages and its cost is independent of
store *capacity* (DESIGN.md §Ragged paged execution). Writes update the
pool **in place** (the JAX package gets the same effect from donated scan
carry). A batched multi-sequence write is one block-table scatter for
every (sequence, token) pair in the step (``page_slots`` says where, once
per step; ``write_slots`` writes each layer), with ragged padding routed to
the layer's trash page.

The **container dtype** follows the device (``store_dtype``): bf16 on
CUDA, f32 on CPU. Stored *values* are always rounded through bf16 first,
so a reader gets the same numbers either way (f32 represents every bf16
exactly) and the CPU store matches the JAX package's bit for bit.

The pool is zero-initialised, never ``torch.empty``: a live page's tail
slots are read with softmax weight 0, and 0 x NaN would be NaN.
"""
from __future__ import annotations

import torch


def store_dtype(device) -> torch.dtype:
    """Container dtype for paged stack stores on ``device``."""
    return torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32


def page_slots(block_table, start, new_lens, S: int, page: int,
               trash_page: int):
    """Where a step's tokens land: (rows, offs), each (B*S,) int64 — the
    page id (before any layer offset) and the slot in the page of token
    ``s`` of row ``b`` at ``b*S + s``.

    block_table: (B, max_pages) page ids per sequence; start: (B,)
    context length already written per sequence; new_lens: (B,) valid
    tokens per row (<= S) — padding tokens and whole padding rows are
    routed to ``trash_page``. Positions are clamped to the table's last
    slot *before* the lookup, so every index is in range (torch
    ``index_put_`` has no drop mode). Duplicate indices land in an
    unspecified order, so callers keep one request's chunks in separate
    steps; only trash-page writes collide."""
    dev = block_table.device
    max_tokens = block_table.shape[1] * page
    ar = torch.arange(S, device=dev, dtype=torch.int64)
    pos = start.to(dev, torch.int64)[:, None] + ar[None, :]          # (B,S)
    valid = ar[None, :] < new_lens.to(dev, torch.int64)[:, None]
    posc = torch.clamp(pos, max=max_tokens - 1)
    rows = torch.gather(block_table.to(torch.int64), 1, posc // page)
    rows = torch.where(valid, rows, torch.full_like(rows, trash_page))
    return rows.reshape(-1), (posc % page).reshape(-1)


def _bf16(x):
    return x if x.dtype == torch.bfloat16 else x.to(torch.bfloat16)


def _put(pages, new, rows, offs):
    """pages[rows, offs] = new (B, S, KV, hd), in the container dtype."""
    flat = new.reshape(-1, *new.shape[2:])
    if flat.dtype != pages.dtype:
        flat = flat.to(pages.dtype)
    pages[rows, offs] = flat


def scatter_pages(k_pages, v_pages, k_new, v_new, block_table, start,
                  new_lens, trash_page, base=0):
    """Scatter S new tokens for each of B sequences into shared page
    tensors, in place, at ``page_slots`` (see there for padding, the
    clamp and duplicates). k_new/v_new: (B, S, KV, hd); base: row offset
    added to every resolved page id — a ``PagedStackStore`` passes
    ``layer * pages_per_layer`` so per-layer tables index the flat pool
    (the per-layer trash lands at ``base + trash_page``).
    Returns (k_pages, v_pages)."""
    rows, offs = page_slots(block_table, start, new_lens, k_new.shape[1],
                            k_pages.shape[1], trash_page)
    _put(k_pages, k_new, rows + base, offs)
    _put(v_pages, v_new, rows + base, offs)
    return k_pages, v_pages


class PagedStackStore:
    """Paged KV for one stack of ``layers`` layers in one flat pool:
    tensors are (layers * pages_per_layer, page, KV, hd) and layer ``l``'s
    page ``p`` is row ``l * pages_per_layer + p``.

    The last page of every layer's range is that layer's trash page
    (ragged padding writes), which is why ``pages_per_layer`` is the
    allocator's ``num_pages + 1``. The attention kernels need no layout
    awareness: ``layer_table`` offsets a block table into the flat pool
    and the kernels just see a bigger page array.
    """

    def __init__(self, k_pages: torch.Tensor, v_pages: torch.Tensor,
                 layers: int):
        self.k_pages = k_pages
        self.v_pages = v_pages
        self.layers = layers

    @classmethod
    def build(cls, layers: int, pages_per_layer: int, page_size: int,
              kv_heads: int, head_dim: int, dtype=None, device="cpu"):
        dtype = store_dtype(device) if dtype is None else dtype
        shape = (layers * pages_per_layer, page_size, kv_heads, head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), layers)

    @property
    def pages_per_layer(self) -> int:
        return self.k_pages.shape[0] // self.layers

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[1]

    @property
    def trash_page(self) -> int:
        return self.pages_per_layer - 1

    def layer_table(self, block_table, layer: int):
        """Per-layer block table -> absolute rows in the flat pool."""
        return block_table + layer * self.pages_per_layer

    def slots(self, block_table, start, new_lens, S: int):
        """``page_slots`` for this store: the same for every layer of a
        step, so the forward computes it once per step."""
        return page_slots(block_table, start, new_lens, S, self.page_size,
                          self.trash_page)

    def write_slots(self, k_new, v_new, slots, *,
                    layer: int) -> "PagedStackStore":
        """Write one layer's new tokens (B, S, KV, hd) in place at
        ``slots``. Values are rounded through bf16 before landing so the
        container dtype never changes what a reader sees (see
        ``store_dtype``). Returns ``self``."""
        rows, offs = slots
        rows = rows + layer * self.pages_per_layer
        _put(self.k_pages, _bf16(k_new), rows, offs)
        _put(self.v_pages, _bf16(v_new), rows, offs)
        return self

    def write_batch(self, k_new, v_new, block_table, start, new_lens, *,
                    layer: int) -> "PagedStackStore":
        """Scatter one layer's new tokens in place (``scatter_pages``;
        values rounded through bf16 as in ``write_slots``). Returns
        ``self``."""
        scatter_pages(self.k_pages, self.v_pages, _bf16(k_new),
                      _bf16(v_new), block_table, start, new_lens,
                      self.trash_page, base=layer * self.pages_per_layer)
        return self

    def copy_page(self, src: int, dst: int) -> "PagedStackStore":
        """Copy one page's K/V across every layer of the stack, in place —
        the prefix cache's copy-on-write boundary-page copy (src stays a
        valid cached page; dst becomes the claimer's private copy)."""
        rows = torch.arange(self.layers, device=self.k_pages.device) * \
            self.pages_per_layer
        for a in (self.k_pages, self.v_pages):
            a[rows + int(dst)] = a[rows + int(src)]
        return self

    def gather_batch(self, block_table, *, layer: int):
        """One layer's view: (B, maxp) -> contiguous
        (B, maxp*page, KV, hd) k, v."""
        rows = self.layer_table(block_table, layer).long()
        B = block_table.shape[0]
        k = self.k_pages[rows].reshape(B, -1, *self.k_pages.shape[-2:])
        v = self.v_pages[rows].reshape(B, -1, *self.v_pages.shape[-2:])
        return k, v
