"""Core transformer layers: norms, grouped-GQA attention over the paged KV
cache, and the dense SwiGLU MLP. Plain functions on tensors: params are
dict trees produced from ParamDecl declarations in transformer.py.

The serving forward calls these once per layer per step, so each layer's
weights are regrouped once at load (``fuse_block``): the three QKV
projections as one matrix, the output projection flattened, the RMSNorm
scales ``1 + w`` precomputed in f32. That keeps the per-layer op count —
and so the host's launch overhead, which bounds a decode step — low; the
arithmetic is the JAX package's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

from .config import ModelConfig
from .rope import apply_rope_tables

NEG_INF = -1e30


def rms_norm(x, w, eps: float = 1e-6):
    """RMSNorm with the ``(1 + w)`` scale, in f32."""
    return rms_norm_scaled(x, 1.0 + w.to(torch.float32), eps)


def rms_norm_scaled(x, scale, eps: float = 1e-6):
    """``rms_norm`` with the f32 scale ``1 + w`` already formed."""
    return F.rms_norm(x.to(torch.float32), (x.shape[-1],), weight=scale,
                      eps=eps).to(x.dtype)


def _softcap(logits, cap: float):
    if cap and cap > 0:
        return torch.tanh(logits / cap) * cap
    return logits


def fuse_block(bp, cfg: ModelConfig) -> dict:
    """One ATTN block's weights (a layer of the ``block_decls`` tree)
    regrouped for the forward: ``ln1``/``ln2`` scales, ``wqkv`` (D,
    (H+2KV)·hd) and its bias, ``wo`` (H·hd, D), and the MLP."""
    a = bp["attn"]
    D = cfg.d_model
    fused = {
        "ln1": 1.0 + bp["ln1"].to(torch.float32),
        "ln2": 1.0 + bp["ln2"].to(torch.float32),
        "wqkv": torch.cat([a["wq"].reshape(D, -1), a["wk"].reshape(D, -1),
                           a["wv"].reshape(D, -1)], dim=1),
        "bqkv": None,
        "wo": a["wo"].reshape(-1, D),
        "mlp": bp["mlp"],
    }
    if cfg.qkv_bias:
        fused["bqkv"] = torch.cat([a["bq"].reshape(-1), a["bk"].reshape(-1),
                                   a["bv"].reshape(-1)])
    return fused


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def qkv_proj(x, p, cfg: ModelConfig):
    """x (B,S,D) -> (B,S,H+2KV,hd): the q, k and v heads side by side, from
    one matmul with the ``fuse_block`` weights."""
    B, S, _ = x.shape
    qkv = x @ p["wqkv"]
    if p["bqkv"] is not None:
        qkv = qkv + p["bqkv"]
    return qkv.view(B, S, cfg.num_heads + 2 * cfg.num_kv_heads, cfg.hd)


def mha(q, k, v, mask, *, softcap: float = 0.0):
    """q (B,Tq,H,hd), k/v (B,Tk,KV,hd), mask broadcastable to (B,H,Tq,Tk)
    or, with GQA, (B,KV,G,Tq,Tk).

    GQA is computed grouped (no materialized kv-head repeat): K/V stay at
    their stored width."""
    B, Tq, H, hd = q.shape
    KV = k.shape[2]
    if KV == H:
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
        logits = _softcap(logits / math.sqrt(hd), softcap)
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
        w = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", w, v)
    G = H // KV
    qg = q.reshape(B, Tq, KV, G, hd)
    logits = torch.einsum("bqcgd,bkcd->bcgqk", qg, k).to(torch.float32)
    logits = _softcap(logits / math.sqrt(hd), softcap)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bcgqk,bkcd->bqcgd", w, v)
    return out.reshape(B, Tq, H, hd)


def paged_attention_block(x, p, cfg: ModelConfig, *, rope, store, ctx,
                          impl: str = "gather"):
    """Attention sub-block over the batched paged KV cache (norm handled by
    the caller).

    x: (B, S, D) — S new tokens per sequence, right-padded (ragged geometry
    in ``ctx``); p: the layer's ``fuse_block`` weights; rope:
    ``rope_tables`` for these positions; store: the stage's flat
    ``PagedStackStore``, written in place; ctx: dict with
      block_table (B, max_pages) int32 — allocator page ids per sequence
        (padding entries point at the per-layer trash page id,
        ``store.trash_page``);
      lengths (B,) int32 — context tokens already written per sequence;
      new_lens (B,) int32 — valid new tokens per row (<= S);
      totals (B,) int32 — lengths + new_lens;
      slots — ``store.slots(...)`` of this step (the scatter's page rows
        and offsets, the same for every layer);
      layer — this layer's index in the stack, offsetting every page
        access into the flat pool via ``store.layer_table``.
    impl: 'kernel' routes S==1 decode through the paged decode kernel and
    S>1 chunked prefill through the paged-prefill kernel (hand-written
    CUDA on the card, their plain versions on CPU) — both attend directly
    over block-table-indexed pages; 'gather' gathers the table-width
    context and runs the same ``mha`` as a dense cache would. Either way
    the attention geometry is the block table's width, which the executor
    length-buckets to the batch's live context.

    Returns (out (B, S, D), store).
    """
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    qkv = qkv_proj(x, p, cfg)
    qk = apply_rope_tables(qkv[:, :, :H + KV], rope)   # q and k together
    q, k, v = qk[:, :, :H], qk[:, :, H:], qkv[:, :, H + KV:]
    bt, lengths, new_lens = ctx["block_table"], ctx["lengths"], ctx["new_lens"]
    layer = ctx["layer"]
    store = store.write_slots(k, v, ctx["slots"], layer=layer)
    if impl == "kernel" and S == 1:
        out = kops.paged_attention(
            q[:, 0].contiguous(), store.k_pages, store.v_pages,
            store.layer_table(bt, layer), ctx["totals"],
            softcap=cfg.logit_softcap)[:, None]
    elif impl == "kernel":
        out = kops.paged_prefill_attention(
            q.contiguous(), store.k_pages, store.v_pages,
            store.layer_table(bt, layer), lengths, new_lens,
            softcap=cfg.logit_softcap)
    else:
        # (B, max_pages*page, KV, hd) — this layer's resident pages only
        ck, cv = store.gather_batch(bt, layer=layer)
        Tk = ck.shape[1]
        dev = x.device
        qpos = lengths.long()[:, None] + torch.arange(S, device=dev)[None, :]
        mask = torch.arange(Tk, device=dev)[None, None, :] <= \
            qpos[:, :, None]                 # (B, S, Tk) per-row causal
        # mha branches on GQA: logits are (b,h,q,k) or (b,kv,g,q,k)
        mask = mask[:, None] if KV == H else mask[:, None, None]
        out = mha(q, ck.to(q.dtype), cv.to(q.dtype), mask,
                  softcap=cfg.logit_softcap)
    return out.reshape(B, S, H * hd) @ p["wo"], store


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_block(x, p):
    """SwiGLU MLP."""
    h = F.silu(x @ p["wi"]) * (x @ p["wg"])
    return h @ p["wo"]
