"""Dense chunked-prefill attention: the hand-written CUDA kernel for Hopper
(``csrc/prefill_attention.cu``) and its plain torch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/prefill_attention.py``
(``prefill_attention``): a chunk of Sq queries at global positions
``q_start .. q_start + Sq - 1`` attends over the contiguous K/V rows
``0 .. n_keys - 1`` under ``kpos <= qpos`` and, with a sliding ``window``,
``kpos > qpos - window``; GQA (query head h reads kv head h // G, no
repeat); optional softcap; masked logits are the reference's finite
-1e30, so a row that sees no key averages V over every key. It carries
the dense-slot cache (every prefill chunk and decode step of the legacy
executor) and the cache-less causal forward.

K and V may be strided views — the first ``n_keys`` rows of a
``(B, Smax, KV, hd)`` slot buffer, or the k/v columns of a fused QKV
activation — as long as each key's (KV, hd) block is contiguous: the
kernel takes their batch and token strides and copies nothing.

Every route walks only the keys ``key_range`` gives: from the first
query's window start to the last query's position (every key when the
last query sees none).

- Chunk route (``Sq·G > 16``): bound by bf16 tensor-core operations (a
  chunk of hundreds of queries at hd 128 does more operations per K/V
  byte than the card's balance point). One block per (sequence, kv head,
  tile of queries), whose BQ·G rows share every K/V tile it reads;
  mma.sync with cp.async double-buffered tiles. wgmma with TMA is later
  work.
- Decode route (``Sq·G <= 16``, hd 64 or 128, 16-byte aligned views):
  bound by bytes, each visible K/V row read once. The Sq·G rows form one
  16-row tensor-core tile, the 4 warps split each 64-key tile, and the
  grid splits the key range into tile-aligned slices (``split_plan``:
  about two blocks per SM, each slice at least four tiles) walked through
  a two-tile cp.async ring; the slices' f32 partial states are
  merged by a second launch. A row that sees no key keeps the reference's
  uniform average: every slice then has the finite mask as its max and
  the merge weighs the slices by their sums.
- Other head dims and unaligned views take an f32-FMA path.

``prefill_attention`` launches the kernel for CUDA tensors (bf16) and
raises on anything it does not take; ``plain`` is the torch version.
``launches`` counts calls that launched the kernel (one a call, however
many CUDA launches it takes).
"""
from __future__ import annotations

import ctypes

import torch

from . import build, split
from .ref import ref_prefill_attention as plain

__all__ = ["prefill_attention", "plain", "check_inputs", "key_range",
           "decode_route", "split_plan", "launches"]

launches = 0
_fn = None

_MAX_G, _MAX_HD = 16, 256


def _launcher():
    global _fn
    if _fn is None:
        f = build.load("prefill_attention").prefill_attention_launch
        f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
            [ctypes.c_longlong] * 4 + [ctypes.c_int] * 2 + \
            [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def key_range(n_keys: int, Sq: int, q_start: int,
              window: int) -> tuple[int, int]:
    """Keys ``[lo, hi)`` that queries at ``q_start .. q_start + Sq - 1`` can
    see; every key when the last query sees none (its window starts past
    the last key), as such rows average V over all of them."""
    p_last = q_start + Sq - 1
    if window > 0 and p_last - window + 1 >= n_keys:
        return 0, n_keys
    lo = max(0, q_start - window + 1) if window > 0 else 0
    return lo, min(n_keys, p_last + 1)


def decode_route(q, k, v) -> bool:
    """Whether the kernel takes the split decode route for these inputs:
    ``Sq·G <= 16`` rows, hd 64 or 128, and K/V rows 16-byte aligned."""
    _, Sq, H, hd = q.shape
    KV = k.shape[2]
    aligned = all(t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0
                  and t.stride(1) % 8 == 0 for t in (k, v))
    return Sq * (H // KV) <= 16 and hd in (64, 128) and aligned


def split_plan(B: int, KV: int, lo: int, hi: int) -> tuple[int, int]:
    """``(n_split, chunk)``: the decode route's keys ``[lo, hi)`` of each of
    the ``B * KV`` (sequence, kv head) pairs cut into tile-aligned slices
    of ``chunk`` keys."""
    return split.plan(B * KV, lo, hi, split.TILE)


def check_inputs(q, k, v, *, q_start: int = 0, window: int = 0):
    """Raise ``ValueError`` unless the kernel takes these tensors."""
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("prefill_attention: all inputs must be on one CUDA "
                         "device")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError("prefill_attention: q, k and v must be bfloat16, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"prefill_attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    kB, n_keys, KV, khd = k.shape
    if kB != B or khd != hd:
        raise ValueError(f"prefill_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if H % KV or H // KV > _MAX_G or hd > _MAX_HD:
        raise ValueError(f"prefill_attention: H={H}, KV={KV}, hd={hd} not "
                         f"supported (need H % KV == 0, G <= {_MAX_G}, "
                         f"hd <= {_MAX_HD})")
    if n_keys < 1 or Sq < 1 or B < 1:
        raise ValueError("prefill_attention: needs at least one query and "
                         "one key per sequence")
    if not q.is_contiguous():
        raise ValueError("prefill_attention: q must be contiguous")
    for name, t in (("k", k), ("v", v)):
        if t.stride(3) != 1 or t.stride(2) != hd:
            raise ValueError(f"prefill_attention: each key's (KV, hd) block "
                             f"of {name} must be contiguous, got strides "
                             f"{t.stride()}")
    if int(q_start) < 0 or int(window) < 0:
        raise ValueError(f"prefill_attention: q_start={q_start} and "
                         f"window={window} must be >= 0")


def prefill_attention(q, k, v, *, q_start: int = 0, window: int = 0,
                      softcap: float = 0.0):
    """q (B,Sq,H,hd) at positions q_start..; k/v (B,n_keys,KV,hd), any
    batch and token strides -> (B,Sq,H,hd). Launches the kernel; raises on
    anything it does not take (``kernels.ops`` routes CPU tensors to
    ``plain``)."""
    global launches
    check_inputs(q, k, v, q_start=q_start, window=window)
    B, Sq, H, hd = q.shape
    n_keys, KV = k.shape[1], k.shape[2]
    q_start, window = int(q_start), int(window)
    out = torch.empty_like(q)
    n_split = chunk = lo = hi = 0   # 0 slices: the chunk (or FMA) route
    part = None
    if decode_route(q, k, v):
        lo, hi = key_range(n_keys, Sq, q_start, window)
        n_split, chunk = split_plan(B, KV, lo, hi)
        if n_split > 1:
            part = torch.empty(B * Sq * H * n_split *
                               split.record_floats(hd),
                               dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            B, Sq, H, KV, hd, n_keys, k.stride(0), k.stride(1), v.stride(0),
            v.stride(1), q_start, window, float(softcap), n_split, chunk,
            lo, hi, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("prefill_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out
