"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

The JAX package's blocks (arXiv:2405.04517 at the block level):
exponential gating with a log-space stabiliser state m, per-head matrix
memory C (mLSTM) and scalar cell state c with a block-diagonal recurrence
(sLSTM). The sequence runs as a Python loop over tokens, one step of
whole-batch tensor ops each, in f32 (``lax.scan`` in the reference),
through ``recurrence``: the dry-run runs three steps and counts the
middle one once a middle token.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .sharding import counted, einsum, halves, replicate, shard_act


def recurrence(step, state, xs, *, mode: str = "loop"):
    """Run ``step(state, *x_t) -> (state, h_t)`` along dim 1 of the
    (B, S, ...) tensors ``xs``: (the state after the last token, the h_t
    stacked along dim 1). ``mode`` "loop" runs every step; "once" (the
    dry-run) runs the first and the last step as themselves and one step
    between them inside ``sharding.counted(S - 2)``, which stands for
    every middle token (its h for each), as the reference's ``lax.scan``
    traces one step for all: a middle step is the only one that takes
    its state from a step and hands it on to another, forward and
    backward."""
    S = xs[0].shape[1]
    if mode == "once" and S > 2:
        hs = []
        for t, n in ((0, 1), (1, S - 2), (S - 1, 1)):
            with counted(n):
                state, h = step(state, *(x[:, t] for x in xs))
                h = h[:, None]        # as torch.stack takes each step's h
            hs.append(h.expand(h.shape[:1] + (n,) + h.shape[2:]))
        return state, torch.cat(hs, dim=1)
    if mode not in ("loop", "once"):
        raise ValueError(f"mode {mode!r}: 'loop' or 'once'")
    hs = []
    for t in range(S):
        state, h = step(state, *(x[:, t] for x in xs))
        hs.append(h)
    return state, torch.stack(hs, dim=1)


def _mlstm_step(state, q, k, v, ig, fg, eps=1e-6):
    """One mLSTM step. state: (C (B,H,d,d), n (B,H,d), m (B,H)); q, k, v
    (B,H,d), ig, fg (B,H) pre-activations."""
    C, n, m = state
    log_f = -F.softplus(-fg)               # log sigmoid(f)
    m_new = torch.maximum(log_f + m, ig)
    i_act = torch.exp(ig - m_new)          # stabilised exp gate
    f_act = torch.exp(log_f + m - m_new)
    C = f_act[..., None, None] * C + i_act[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = f_act[..., None] * n + i_act[..., None] * k
    h_num = einsum("bhd,bhde->bhe", q, C)
    h_den = torch.abs(einsum("bhd,bhd->bh", q, n))
    h = h_num / torch.clamp(torch.maximum(h_den, torch.exp(-m_new))[..., None],
                            min=eps)
    return (C, n, m_new), h


def mlstm_block(x, p, cfg: ModelConfig, *, cache=None, scan="loop"):
    """mLSTM block with up-projection (factor ``cfg.xlstm_proj_factor``).

    x (B, S, D). cache: {"C": (B,H,d,d), "n": (B,H,d), "m": (B,H)}, the
    state before x. ``scan``: ``recurrence``'s mode. Returns (out (B, S,
    D), the state after x as new tensors)."""
    B, S, D = x.shape
    H = cfg.num_heads
    DI = int(cfg.xlstm_proj_factor * D)
    hd = DI // H
    xin, z = halves(x @ p["up_proj"])                       # (B, S, DI) x 2
    xin = shard_act(xin, "batch", "seq", "inner")

    # the products over the sharded inner dim are partial sums: resolved
    # once a block, onto each rank's heads, so that every step of the
    # recurrence runs on its heads alone
    def heads(w, b):
        return shard_act((xin @ w + b).reshape(B, S, H, hd), "batch", "seq",
                         "heads", None).to(torch.float32)

    def gate(w, b):
        return shard_act(xin @ w + b, "batch", "seq", "heads").to(
            torch.float32)

    q = heads(p["wq"], p["bq"])
    k = heads(p["wk"], p["bk"]) / math.sqrt(hd)
    v = heads(p["wv"], p["bv"])
    ig, fg = gate(p["wi_g"], p["bi_g"]), gate(p["wf_g"], p["bf_g"])

    if cache is not None:
        state = tuple(cache[s].to(torch.float32) for s in ("C", "n", "m"))
    else:
        state = tuple(replicate(t) for t in (
            torch.zeros((B, H, hd, hd), device=x.device),
            torch.zeros((B, H, hd), device=x.device),
            torch.full((B, H), -1e30, device=x.device)))
    state, h = recurrence(_mlstm_step, state, (q, k, v, ig, fg), mode=scan)
    h = h.reshape(B, S, DI).to(x.dtype)
    h = h * F.silu(z)
    out = shard_act(h @ p["down_proj"], "batch", "seq", "embed_act")
    return out, {"C": state[0], "n": state[1], "m": state[2]}


def slstm_block(x, p, cfg: ModelConfig, *, cache=None, scan="loop"):
    """sLSTM block: scalar memory with per-head recurrent connections,
    followed by a gated FFN (factor 4/3, as in the paper).

    cache: {"c", "n", "m", "h": (B, H, d)}, the state before x. ``scan``:
    ``recurrence``'s mode. Returns (out (B, S, D), the state after x as
    new tensors)."""
    B, S, D = x.shape
    H = cfg.num_heads
    hd = D // H
    xh = x.reshape(B, S, H, hd)

    def gate_x(w, b):
        return (torch.einsum("bshd,hde->bshe", xh, w) + b).to(torch.float32)

    zx, ix, fx, ox = (gate_x(p["W" + g], p["b" + g]) for g in "zifo")
    # the four recurrent matrices side by side: one product a step
    R = torch.cat([p["R" + g].to(torch.float32) for g in "zifo"], dim=-1)

    if cache is not None:
        state = tuple(cache[s].to(torch.float32) for s in ("c", "n", "m",
                                                           "h"))
    else:
        state = tuple(replicate(f((B, H, hd), device=x.device)) for f in
                      (torch.zeros, torch.ones, torch.zeros, torch.zeros))

    def step(state, zx_t, ix_t, fx_t, ox_t):
        c, n, m, h = state
        rz, ri, rf, ro = torch.einsum("bhd,hde->bhe", h, R).split(hd, dim=-1)
        zt = torch.tanh(zx_t + rz)
        it = ix_t + ri
        ft = fx_t + rf
        ot = torch.sigmoid(ox_t + ro)
        log_f = -F.softplus(-ft)
        m_new = torch.maximum(log_f + m, it)
        i_act = torch.exp(it - m_new)
        f_act = torch.exp(log_f + m - m_new)
        c = f_act * c + i_act * zt
        n = f_act * n + i_act
        h = ot * c / torch.clamp(n, min=1e-6)
        return (c, n, m_new, h), h

    (c, n, m, h), y = recurrence(step, state, (zx, ix, fx, ox), mode=scan)
    # each rank's heads, gathered for the FFN (its columns sharded)
    y = shard_act(y.reshape(B, S, D).to(x.dtype), "batch", "seq",
                  "embed_act")
    # gated FFN
    g = F.gelu(y @ p["ff_up"], approximate="tanh")
    y = (g * (y @ p["ff_gate"])) @ p["ff_down"]
    return shard_act(y, "batch", "seq", "embed_act"), \
        {"c": c, "n": n, "m": m, "h": h}
