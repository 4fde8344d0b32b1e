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

Bound on an H100: a prefill chunk of hundreds of queries at hd 128 does
more operations per K/V byte than the card's balance point, so bf16
tensor-core operations bound it; a decode step (Sq = 1) reads each visible
K/V row once and is bound by bytes. The kernel runs one block per
(sequence, kv head, tile of queries), whose BQ·G rows share every K/V
tile it reads, and walks only the keys its queries can see (from the first
one's window start to the last one's position). For hd 64 and 128 the
products run on the tensor cores (mma.sync, cp.async double-buffered
tiles); other head dims use f32 FMAs. wgmma with TMA and a split over keys
for a small decode grid (B·KV blocks) are later work.

``prefill_attention`` launches the kernel for CUDA tensors (bf16) and
raises on anything it does not take; ``plain`` is the torch version.
``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import ref_prefill_attention as plain

__all__ = ["prefill_attention", "plain", "check_inputs", "launches"]

launches = 0
_fn = None

_MAX_G, _MAX_HD = 16, 256


def _launcher():
    global _fn
    if _fn is None:
        f = build.load("prefill_attention").prefill_attention_launch
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
            [ctypes.c_longlong] * 4 + [ctypes.c_int] * 2 + \
            [ctypes.c_float, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


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
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, H, KV, hd, n_keys, k.stride(0), k.stride(1), v.stride(0),
            v.stride(1), int(q_start), int(window), float(softcap),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("prefill_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out
