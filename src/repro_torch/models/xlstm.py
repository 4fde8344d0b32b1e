"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

The JAX package's blocks (arXiv:2405.04517 at the block level):
exponential gating with a log-space stabiliser state m, per-head matrix
memory C (mLSTM) and scalar cell state c with a block-diagonal recurrence
(sLSTM). The sequence runs as a Python loop over tokens, one step of
whole-batch tensor ops each, in f32 (``lax.scan`` in the reference).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .sharding import einsum, replicate, shard_act


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


def mlstm_block(x, p, cfg: ModelConfig, *, cache=None):
    """mLSTM block with up-projection (factor ``cfg.xlstm_proj_factor``).

    x (B, S, D). cache: {"C": (B,H,d,d), "n": (B,H,d), "m": (B,H)}, the
    state before x. Returns (out (B, S, D), the state after x as new
    tensors)."""
    B, S, D = x.shape
    H = cfg.num_heads
    DI = int(cfg.xlstm_proj_factor * D)
    hd = DI // H
    up = x @ p["up_proj"]                                   # (B, S, 2*DI)
    xin, z = up[..., :DI], up[..., DI:]
    xin = shard_act(xin, "batch", "seq", "inner")

    def heads(w, b):
        return (xin @ w + b).reshape(B, S, H, hd).to(torch.float32)

    q = heads(p["wq"], p["bq"])
    k = heads(p["wk"], p["bk"]) / math.sqrt(hd)
    v = heads(p["wv"], p["bv"])
    ig = (xin @ p["wi_g"] + p["bi_g"]).to(torch.float32)
    fg = (xin @ p["wf_g"] + p["bf_g"]).to(torch.float32)

    if cache is not None:
        state = tuple(cache[s].to(torch.float32) for s in ("C", "n", "m"))
    else:
        state = tuple(replicate(t) for t in (
            torch.zeros((B, H, hd, hd), device=x.device),
            torch.zeros((B, H, hd), device=x.device),
            torch.full((B, H), -1e30, device=x.device)))
    hs = []
    for t in range(S):
        state, h = _mlstm_step(state, q[:, t], k[:, t], v[:, t], ig[:, t],
                               fg[:, t])
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, S, DI).to(x.dtype)
    h = h * F.silu(z)
    out = shard_act(h @ p["down_proj"], "batch", "seq", "embed_act")
    return out, {"C": state[0], "n": state[1], "m": state[2]}


def slstm_block(x, p, cfg: ModelConfig, *, cache=None):
    """sLSTM block: scalar memory with per-head recurrent connections,
    followed by a gated FFN (factor 4/3, as in the paper).

    cache: {"c", "n", "m", "h": (B, H, d)}, the state before x. Returns
    (out (B, S, D), the state after x as new tensors)."""
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
        c, n, m, h = (cache[s].to(torch.float32) for s in ("c", "n", "m", "h"))
    else:
        c, n, m, h = (replicate(f((B, H, hd), device=x.device)) for f in
                      (torch.zeros, torch.ones, torch.zeros, torch.zeros))
    hs = []
    for t in range(S):
        rz, ri, rf, ro = torch.einsum("bhd,hde->bhe", h, R).split(hd, dim=-1)
        zt = torch.tanh(zx[:, t] + rz)
        it = ix[:, t] + ri
        ft = fx[:, t] + rf
        ot = torch.sigmoid(ox[:, t] + ro)
        log_f = -F.softplus(-ft)
        m_new = torch.maximum(log_f + m, it)
        i_act = torch.exp(it - m_new)
        f_act = torch.exp(log_f + m - m_new)
        c = f_act * c + i_act * zt
        n = f_act * n + i_act
        m = m_new
        h = ot * c / torch.clamp(n, min=1e-6)
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(B, S, D).to(x.dtype)
    # gated FFN
    g = F.gelu(y @ p["ff_up"], approximate="tanh")
    y = (g * (y @ p["ff_gate"])) @ p["ff_down"]
    return shard_act(y, "batch", "seq", "embed_act"), \
        {"c": c, "n": n, "m": m, "h": h}
