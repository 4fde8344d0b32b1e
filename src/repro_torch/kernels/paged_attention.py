"""Paged decode attention: the hand-written CUDA kernel for Hopper
(``csrc/paged_attention.cu``) and its plain torch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/paged_attention.py``
(``paged_attention``): one query token per sequence attends over its
block-table pages; GQA grouped as (KV, G, hd); optional tanh softcap; mask
``tpos < length``; rows with length 0 give exact zeros.

Bound on an H100: bytes — the live K/V pages, read once (about 2·G flops
per bf16 element, far under the card's flops-per-byte balance). To fill
the card at small batch the kernel splits each row's keys over blocks
(flash-decoding): ``split_plan`` cuts the widest row the block table can
hold (``max_pages * page``; the lengths stay on the device) into
page-aligned slices, enough for about two blocks per SM, each at least
four 64-key tiles. Block (sequence, kv head, slice) walks the slice's keys
below the row's length through its staged block-table entries, with a
three-tile ring of 16-byte cp.async copies (two tiles in flight against
the math); for hd 64 and 128 the G query heads form one 16-row
tensor-core tile and each 64-key tile is split over 4 warps, other head
dims use f32 FMAs. With
more than one slice the blocks write f32 partial softmax states to
scratch and a second launch merges them into the bf16 output; a row of
length 0 stays exact zeros.

``paged_attention`` launches the kernel for CUDA tensors (bf16 q and
pages, int32 table and lengths) and raises on anything it does not take;
``plain`` is the torch version the CPU path and the checks use. ``launches``
counts calls that launched the kernel (one a call, however many CUDA
launches it takes).
"""
from __future__ import annotations

import ctypes

import torch

from . import build, split
from .ref import ref_paged_attention as plain

__all__ = ["paged_attention", "plain", "check_inputs", "split_plan",
           "launches"]

launches = 0
_fn = None

_MAX_G, _MAX_HD, _MAX_TABLE = 16, 256, 8192


def _launcher():
    global _fn
    if _fn is None:
        f = build.load("paged_attention").paged_attention_launch
        f.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + \
            [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def split_plan(B: int, KV: int, max_keys: int, page: int) -> tuple[int, int]:
    """``(n_split, chunk)``: the keys ``[0, max_keys)`` of each of the
    ``B * KV`` (sequence, kv head) pairs cut into slices of ``chunk`` keys,
    a multiple of the page (and of the 64-key tile where the page divides
    it)."""
    return split.plan(B * KV, 0, max_keys, page * max(1, split.TILE // page))


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
    maxp = block_table.shape[1]
    n_split, chunk = split_plan(B, KV, maxp * page, page)
    out = torch.empty_like(q)
    part = None
    if n_split > 1:
        part = torch.empty(B * H * n_split * split.record_floats(hd),
                           dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _launcher()(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            B, H, KV, hd, page, maxp, float(softcap), n_split, chunk,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out
