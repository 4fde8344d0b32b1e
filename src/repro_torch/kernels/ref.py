"""Plain torch versions of the attention kernels.

They compute exactly what ``repro.kernels.ref`` computes (the oracles of
the JAX package), in f32, and are the ground truth each hand-written CUDA
kernel is held against. On a CPU tensor the kernel wrappers in
``kernels.ops`` run these.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _softcap(logits, softcap: float):
    if softcap > 0:
        return torch.tanh(logits / softcap) * softcap
    return logits


def causal_mask(q_start, q_len: int, kv_len: int, window: int = 0,
                device=None):
    """mask (q_len, kv_len): query i (global position q_start + i) may
    attend key j."""
    qpos = q_start + torch.arange(q_len, device=device)[:, None]
    kpos = torch.arange(kv_len, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m = m & (kpos > qpos - window)
    return m


def ref_prefill_attention(q, k, v, *, q_start: int = 0, window: int = 0,
                          softcap: float = 0.0):
    """Chunked-prefill causal attention.

    q: (B, Sq, H, hd) — queries at global positions [q_start, q_start+Sq)
    k, v: (B, Skv, KV, hd) — the context so far; a q_start beyond Skv
       (a decode past the end of a full slot buffer) sees every key
    window: sliding window size (0 = full causal). A row that sees no key
       gets uniform weights over all Skv (the finite NEG_INF mask).
    """
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    if KV != H:
        rep = H // KV
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    mask = causal_mask(q_start, Sq, k.shape[1], window, device=q.device)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / \
        math.sqrt(hd)
    logits = _softcap(logits, softcap)
    logits = torch.where(mask[None, None], logits,
                         torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
    return out.to(q.dtype)


def _gather_context(k_pages, v_pages, block_table, H):
    """(B, maxp) table -> contiguous (B, maxp*page, H, hd) f32 K/V, kv
    heads repeated to H."""
    B, maxp = block_table.shape
    _, page, KV, hd = k_pages.shape
    bt = block_table.long()
    k = k_pages[bt].reshape(B, maxp * page, KV, hd).float()
    v = v_pages[bt].reshape(B, maxp * page, KV, hd).float()
    if KV != H:
        k = torch.repeat_interleave(k, H // KV, dim=2)
        v = torch.repeat_interleave(v, H // KV, dim=2)
    return k, v


def ref_paged_attention(q, k_pages, v_pages, block_table, lengths, *,
                        softcap: float = 0.0):
    """Decode-phase paged attention.

    q: (B, H, hd) — one query token per sequence
    k_pages/v_pages: (num_pages, page_size, KV, hd)
    block_table: (B, max_pages) int32 — page ids per sequence
    lengths: (B,) int32 — context length (tokens) per sequence
    Rows with length 0 come out as exact zeros.
    """
    B, H, hd = q.shape
    k, v = _gather_context(k_pages, v_pages, block_table, H)
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = kpos < lengths.long()[:, None]
    logits = torch.einsum("bhd,bkhd->bhk", q.float(), k) / math.sqrt(hd)
    logits = _softcap(logits, softcap)
    logits = torch.where(mask[:, None], logits,
                         torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", w, v)
    # length-0 guard: a fully-masked row would softmax to uniform weights
    # over stale page contents; padding rows in bucketed batches hit this
    out = torch.where(lengths.long()[:, None, None] > 0, out,
                      torch.zeros_like(out))
    return out.to(q.dtype)


def ref_paged_prefill_attention(q, k_pages, v_pages, block_table, q_start,
                                new_lens, *, softcap: float = 0.0):
    """Packed chunked-prefill attention over the paged KV cache.

    q: (B, S, H, hd) — right-padded chunks at per-row global positions
       [q_start[b], q_start[b] + new_lens[b]);
    k_pages/v_pages: (num_pages, page_size, KV, hd), already holding the
       chunk's own K/V;
    block_table: (B, max_pages) int32;
    q_start: (B,) int32 context tokens before this chunk;
    new_lens: (B,) int32 valid chunk tokens (<= S). Outputs at padding
    positions (i >= new_lens[b]) are exact zeros.
    """
    B, S, H, hd = q.shape
    k, v = _gather_context(k_pages, v_pages, block_table, H)
    dev = q.device
    qpos = q_start.long()[:, None] + torch.arange(S, device=dev)[None, :]
    kpos = torch.arange(k.shape[1], device=dev)[None, None, :]
    mask = kpos <= qpos[:, :, None]                           # (B, S, Tk)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / math.sqrt(hd)
    logits = _softcap(logits, softcap)
    logits = torch.where(mask[:, None], logits,
                         torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v)
    pad = torch.arange(S, device=dev)[None, :] < new_lens.long()[:, None]
    out = torch.where(pad[:, :, None, None], out, torch.zeros_like(out))
    return out.to(q.dtype)
