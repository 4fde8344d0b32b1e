"""Paged decode attention: the hand-written CUDA kernel for Hopper
(``csrc/paged_attention.cu``) and its plain torch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/paged_attention.py``
(``paged_attention``): one query token per sequence attends over its
block-table pages; GQA grouped as (KV, G, hd); optional tanh softcap; mask
``tpos < length``; rows with length 0 give exact zeros.

Bound on an H100: bytes — the live K/V pages, read once (about 2·G flops
per bf16 element, far under the card's flops-per-byte balance). The kernel
runs one block per (sequence, kv head): it walks only the sequence's
``ceil(length / page)`` pages through its own block-table row, staged in
shared memory, with 16-byte cp.async copies double-buffered against the
math, so each K/V byte crosses the memory bus once; the online softmax
stays in f32. For hd 64 and 128 the G query heads form one 16-row
tensor-core tile and each 64-key tile is split over 4 warps whose softmax
states merge at the end; other head dims use f32 FMAs. Splitting long
contexts over several blocks (flash-decoding) to fill the card at small
batch is later work.

``paged_attention`` launches the kernel for CUDA tensors (bf16 q and
pages, int32 table and lengths) and raises on anything it does not take;
``plain`` is the torch version the CPU path and the checks use. ``launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import ref_paged_attention as plain

__all__ = ["paged_attention", "plain", "check_inputs", "launches"]

launches = 0
_fn = None

_MAX_G, _MAX_HD, _MAX_TABLE = 16, 256, 8192


def _launcher():
    global _fn
    if _fn is None:
        f = build.load("paged_attention").paged_attention_launch
        f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + \
            [ctypes.c_float, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def check_inputs(q, k_pages, v_pages, block_table, lengths):
    """Raise ``ValueError`` unless the kernel takes these tensors."""
    if not all(t.is_cuda and t.device == q.device
               for t in (q, k_pages, v_pages, block_table, lengths)):
        raise ValueError("paged_attention: all inputs must be on one CUDA "
                         "device")
    if q.dtype != torch.bfloat16 or k_pages.dtype != torch.bfloat16 or \
            v_pages.dtype != torch.bfloat16:
        raise ValueError("paged_attention: q and pages must be bfloat16, got "
                         f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_attention: block_table and lengths must be "
                         "int32")
    if q.ndim != 3 or k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"paged_attention: bad shapes q {tuple(q.shape)}, "
                         f"pages {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)}")
    B, H, hd = q.shape
    _, page, KV, khd = k_pages.shape
    if khd != hd or H % KV or H // KV > _MAX_G or hd > _MAX_HD:
        raise ValueError(f"paged_attention: H={H}, KV={KV}, hd={hd} not "
                         f"supported (need H % KV == 0, G <= {_MAX_G}, "
                         f"hd <= {_MAX_HD})")
    if block_table.ndim != 2 or block_table.shape[0] != B or \
            tuple(lengths.shape) != (B,):
        raise ValueError("paged_attention: block_table (B, max_pages) and "
                         "lengths (B,) must match q's batch")
    if block_table.shape[1] > _MAX_TABLE:
        raise ValueError(f"paged_attention: block tables wider than "
                         f"{_MAX_TABLE} pages are not supported")
    if not all(t.is_contiguous()
               for t in (q, k_pages, v_pages, block_table, lengths)):
        raise ValueError("paged_attention: inputs must be contiguous")


def paged_attention(q, k_pages, v_pages, block_table, lengths, *,
                    softcap: float = 0.0):
    """q (B,H,hd); k/v_pages (P,page,KV,hd); block_table (B,maxp) int32;
    lengths (B,) int32 -> (B,H,hd). Launches the kernel; raises on
    anything it does not take (``kernels.ops`` routes CPU tensors to
    ``plain``)."""
    global launches
    check_inputs(q, k_pages, v_pages, block_table, lengths)
    B, H, hd = q.shape
    _, page, KV, _ = k_pages.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _launcher()(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, H, KV, hd, page, block_table.shape[1], float(softcap),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out
