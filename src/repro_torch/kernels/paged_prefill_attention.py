"""Paged chunked-prefill attention: the hand-written CUDA kernel for Hopper
(``csrc/paged_prefill_attention.cu``) and its plain torch version.

Replaces the Pallas TPU kernel
``src/repro/kernels/paged_prefill_attention.py`` (``paged_prefill_attention``):
each sequence's right-padded chunk of Sq queries, at global positions
``q_start[b] .. q_start[b] + new_lens[b]``, attends causally over that
sequence's block-table pages (which already hold the chunk's K/V), under
``tpos <= qpos & tpos < total``; GQA; optional softcap; padding queries and
padding rows are exact zeros.

Bound on an H100: at the serving shapes (hd 128, chunks of hundreds of
queries) the two products do more operations per K/V byte than the card's
balance point, so the bound is bf16 tensor-core operations. For hd 64 and
128 the kernel (``csrc/prefill_wgmma.cuh``) runs one block per (sequence,
kv head, tile of BQ queries, ``tiles.plan``): the tile's BQ·G <= 128 query
rows attend together on wgmma, two consumer warpgroups of 64 rows, while
a producer warpgroup copies K/V tiles of 128 keys through the sequence's
block-table row (cp.async into a ring, tracked by mbarriers). A
block stops at the last key its last real query can see (padding tiles
read nothing), and the tiles late in a chunk start first. Other head dims
take an f32-FMA path.

``paged_prefill_attention`` launches the kernel for CUDA tensors (bf16 q
and pages, int32 vectors) and raises on anything it does not take;
``plain`` is the torch version. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, tiles
from .ref import ref_paged_prefill_attention as plain

__all__ = ["paged_prefill_attention", "plain", "check_inputs", "launches"]

launches = 0
_fn = None

_MAX_G, _MAX_HD, _MAX_TABLE = 16, 256, 8192


def _launcher():
    global _fn
    if _fn is None:
        f = build.load("paged_prefill_attention")\
            .paged_prefill_attention_launch
        f.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + \
            [ctypes.c_float, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def check_inputs(q, k_pages, v_pages, block_table, q_start, new_lens):
    """Raise ``ValueError`` unless the kernel takes these tensors."""
    ts = (q, k_pages, v_pages, block_table, q_start, new_lens)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("paged_prefill_attention: all inputs must be on one "
                         "CUDA device")
    if q.dtype != torch.bfloat16 or k_pages.dtype != torch.bfloat16 or \
            v_pages.dtype != torch.bfloat16:
        raise ValueError("paged_prefill_attention: q and pages must be "
                         f"bfloat16, got {q.dtype}/{k_pages.dtype}/"
                         f"{v_pages.dtype}")
    if any(t.dtype != torch.int32 for t in (block_table, q_start, new_lens)):
        raise ValueError("paged_prefill_attention: block_table, q_start and "
                         "new_lens must be int32")
    if q.ndim != 4 or k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("paged_prefill_attention: bad shapes q "
                         f"{tuple(q.shape)}, pages {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)}")
    B, Sq, H, hd = q.shape
    _, page, KV, khd = k_pages.shape
    if khd != hd or H % KV or H // KV > _MAX_G or hd > _MAX_HD:
        raise ValueError(f"paged_prefill_attention: H={H}, KV={KV}, hd={hd} "
                         f"not supported (need H % KV == 0, G <= {_MAX_G}, "
                         f"hd <= {_MAX_HD})")
    if block_table.ndim != 2 or block_table.shape[0] != B or \
            tuple(q_start.shape) != (B,) or tuple(new_lens.shape) != (B,):
        raise ValueError("paged_prefill_attention: block_table (B, max_pages)"
                         ", q_start (B,) and new_lens (B,) must match q's "
                         "batch")
    if block_table.shape[1] > _MAX_TABLE:
        raise ValueError(f"paged_prefill_attention: block tables wider than "
                         f"{_MAX_TABLE} pages are not supported")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged_prefill_attention: inputs must be contiguous")


def paged_prefill_attention(q, k_pages, v_pages, block_table, q_start,
                            new_lens, *, softcap: float = 0.0):
    """q (B,Sq,H,hd); k/v_pages (P,page,KV,hd); block_table (B,maxp) int32;
    q_start/new_lens (B,) int32 -> (B,Sq,H,hd). Launches the kernel; raises
    on anything it does not take (``kernels.ops`` routes CPU tensors to
    ``plain``)."""
    global launches
    check_inputs(q, k_pages, v_pages, block_table, q_start, new_lens)
    B, Sq, H, hd = q.shape
    _, page, KV, _ = k_pages.shape
    bq, n_tiles = tiles.plan(Sq, H // KV)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _launcher()(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), q_start.data_ptr(), new_lens.data_ptr(),
            out.data_ptr(), B, Sq, H, KV, hd, page, block_table.shape[1],
            bq, n_tiles, float(softcap),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("paged_prefill_attention kernel launch failed: "
                           f"CUDA error {rc}")
    launches += 1
    return out
