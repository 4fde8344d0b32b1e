"""Mamba selective-SSM block (Jamba's recurrent layer).

The recurrence ``h_t = a_t * h_{t-1} + b_t`` runs in f32 over chunks of
the sequence, carrying the (B, DI, N) state from chunk to chunk; within a
chunk an inclusive scan by doubling (log2 Q steps of whole-tensor ops)
composes the ``(a, b)`` pairs, and the chunk's states are ``a_c * h0 +
b_c`` as in the JAX package's chunked associative scan. The materialised
state tensor is (B, Q, DI, N) for chunk size Q, never (B, S, DI, N).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .sharding import halves, replicate, shard_act


def _scan_chunk(a, b, h0):
    """Linear recurrence h_t = a_t * h_{t-1} + b_t within a chunk.

    a, b: (B, Q, DI, N) f32; h0: (B, DI, N). Returns (h_all (B, Q, DI, N),
    h_last)."""
    Q = a.shape[1]
    d = 1
    while d < Q:
        # (a1, b1) then (a2, b2) composes to (a1 a2, a2 b1 + b2)
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    h_all = a * h0[:, None] + b
    return h_all, h_all[:, -1]


def mamba_block(x, p, cfg: ModelConfig, *, cache=None, chunk: int = 256):
    """x (B, S, D) -> (y (B, S, D), new_cache).

    cache (prefill over a slot, decode): {"conv": (B, d_conv-1, DI), "ssm":
    (B, DI, N) f32}, read as the state before x; the returned
    ``new_cache`` holds the state after it (``conv`` in the cache's dtype),
    as new tensors: the caller writes them back."""
    B, S, D = x.shape
    DI, N, KC = cfg.d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    xi, z = halves(x @ p["in_proj"])                        # (B, S, DI) x 2
    xi = shard_act(xi, "batch", "seq", "inner")

    # causal depthwise conv, kernel KC
    w = p["conv_w"]                                         # (KC, DI)
    if cache is not None:
        prev = cache["conv"].to(xi.dtype)                   # (B, KC-1, DI)
        xpad = torch.cat([prev, xi], dim=1)
    else:
        xpad = torch.cat([xi.new_zeros((B, KC - 1, DI)), xi], dim=1)
    new_conv = xpad[:, -(KC - 1):]
    xc = sum(xpad[:, i:i + S] * w[i] for i in range(KC)) + p["conv_b"]
    xc = F.silu(xc)

    # SSM parameters (input-dependent); the products over the sharded
    # inner dim are partial sums, resolved here while they are small, side
    # by side in one all-reduce, as XLA resolves them
    R = p["dt_down"].shape[1]
    dBC = shard_act(torch.cat([xc @ p["dt_down"], xc @ p["wB"],
                               xc @ p["wC"]], dim=-1), "batch", "seq", None)
    dt_low, Bm, Cm = dBC[..., :R], dBC[..., R:R + N], dBC[..., R + N:]
    dt = F.softplus(dt_low @ p["dt_up"] + p["dt_bias"])
    A = -torch.exp(p["A_log"].to(torch.float32))            # (DI, N)

    dt32, xc32 = dt.to(torch.float32), xc.to(torch.float32)
    h = (replicate(torch.zeros((B, DI, N), dtype=torch.float32,
                               device=x.device))
         if cache is None else cache["ssm"].to(torch.float32))

    def chunk_terms(dt_c, B_c, x_c):
        a = torch.exp(dt_c[..., None] * A)                  # (B, Q, DI, N)
        b = (dt_c * x_c)[..., None] * B_c[:, :, None, :].to(torch.float32)
        return a, b

    if S == 1:  # decode
        a, b = chunk_terms(dt32, Bm, xc32)
        h = a[:, 0] * h + b[:, 0]
        y = torch.einsum("bin,bn->bi", h,
                         Cm[:, 0].to(torch.float32))[:, None]
    else:
        ys = []
        for s0 in range(0, S, chunk):
            s1 = min(S, s0 + chunk)
            a, b = chunk_terms(dt32[:, s0:s1], Bm[:, s0:s1], xc32[:, s0:s1])
            h_all, h = _scan_chunk(a, b, h)
            ys.append(torch.einsum("bsin,bsn->bsi", h_all,
                                   Cm[:, s0:s1].to(torch.float32)))
        y = torch.cat(ys, dim=1)

    y = (y + xc32 * p["D_skip"].to(torch.float32)).to(x.dtype)
    y = y * F.silu(z)
    out = y @ p["out_proj"]
    conv_dt = cache["conv"].dtype if cache is not None else new_conv.dtype
    return shard_act(out, "batch", "seq", "embed_act"), \
        {"conv": new_conv.to(conv_dt), "ssm": h}
