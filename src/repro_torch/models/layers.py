"""Core transformer layers: norms, grouped-GQA attention (over the paged KV
cache, over a dense slot cache, or with no cache), the dense SwiGLU MLP
and the capacity-based MoE. Plain functions on tensors: params are dict
trees produced from ParamDecl declarations in transformer.py.

The serving forward calls these once per layer per step, so each layer's
weights are regrouped once at load (``fuse_block``): the three QKV
projections as one matrix, the output projection flattened, the RMSNorm
scales ``1 + w`` precomputed in f32. That keeps the per-layer op count —
and so the host's launch overhead, which bounds a decode step — low; the
arithmetic is the JAX package's.

With sharding rules installed (the dry-run, ``models.sharding``) the
weights are ``DTensor``s, the caller keeps q, k and v apart
(``fuse_block(..., fuse_qkv=False)``: a concatenation along the sharded
heads would gather them), and the activations carry the reference's
``shard_act`` annotations, which are the identity otherwise.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import causal_mask

from .config import ModelConfig
from .rope import apply_rope_tables
from .sharding import (current_rules, einsum, replicate, shard_act,
                       whole_grad)

NEG_INF = -1e30


def rms_norm(x, w, eps: float = 1e-6):
    """RMSNorm with the ``(1 + w)`` scale, in f32."""
    return rms_norm_scaled(x, 1.0 + w.to(torch.float32), eps)


def rms_norm_scaled(x, scale, eps: float = 1e-6):
    """``rms_norm`` with the f32 scale ``1 + w`` already formed."""
    return F.rms_norm(x.to(torch.float32), (x.shape[-1],), weight=scale,
                      eps=eps).to(x.dtype)


def layer_norm(x, w, b, eps: float = 1e-6):
    """LayerNorm in f32 (the encoder-decoder's norm). Under sharding rules
    it is written out (mean, variance, scale and shift), its output's
    gradient summed whole first (``whole_grad``): DTensor's own LayerNorm
    backward redistributes a partial gradient as its version picks (a
    reduce-scatter on one torch, an all-reduce on another)."""
    x32, w32, b32 = (t.to(torch.float32) for t in (x, w, b))
    if current_rules() is None:
        return F.layer_norm(x32, (x.shape[-1],), weight=w32, bias=b32,
                            eps=eps).to(x.dtype)
    xc = x32 - x32.mean(dim=-1, keepdim=True)
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return whole_grad((xc * torch.rsqrt(var + eps) * w32 + b32).to(x.dtype))


def _softcap(logits, cap: float):
    if cap and cap > 0:
        return torch.tanh(logits / cap) * cap
    return logits


def fuse_attn(a, cfg: ModelConfig) -> dict:
    """One layer's attention weights (the ``attn`` subtree) regrouped:
    ``wqkv`` (D, (H+2KV)·hd) and its bias, ``wo`` (H·hd, D)."""
    D = cfg.d_model
    fused = {
        "wqkv": torch.cat([a["wq"].reshape(D, -1), a["wk"].reshape(D, -1),
                           a["wv"].reshape(D, -1)], dim=1),
        "bqkv": None,
        "wo": a["wo"].reshape(-1, D),
    }
    if cfg.qkv_bias:
        fused["bqkv"] = torch.cat([a["bq"].reshape(-1), a["bk"].reshape(-1),
                                   a["bv"].reshape(-1)])
    return fused


NORMS = ("ln1", "ln2", "ln_x")


def fuse_block(bp, cfg: ModelConfig, *, fuse_qkv: bool = True) -> dict:
    """One block's weights (a layer of the ``block_decls`` tree) regrouped
    for the forward: each RMSNorm as its f32 scale ``1 + w`` (LayerNorm
    weights and biases as they are), an ``attn`` subtree as the
    ``fuse_attn`` weights at the top level; every other subtree (``mlp``,
    ``moe``, ``cross``, ``mamba``, ``core``) unchanged. ``fuse_qkv=False``
    (the dry-run) keeps ``wq``, ``wk``, ``wv`` and their biases (None
    without) apart, for three products in ``qkv_rope``."""
    out = {}
    for name, a in bp.items():
        if name == "attn" and not fuse_qkv:
            out.update({n: a.get(n) for n in ("wq", "wk", "wv", "bq", "bk",
                                              "bv")},
                       wo=a["wo"].reshape(-1, cfg.d_model))
        elif name == "attn":
            out.update(fuse_attn(a, cfg))
        elif name in NORMS and cfg.norm_style() == "rmsnorm":
            out[name] = 1.0 + a.to(torch.float32)
        else:
            out[name] = a
    return out


def norm(x, p, cfg: ModelConfig, name: str):
    """The block's norm ``name`` over ``fuse_block`` weights: LayerNorm for
    the encoder-decoder, RMSNorm otherwise."""
    if cfg.norm_style() == "layernorm":
        return layer_norm(x, p[name], p[name + "_b"], cfg.norm_eps)
    return rms_norm_scaled(x, p[name], cfg.norm_eps)


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


def qkv_rope(x, p, cfg: ModelConfig, rope):
    """x (B,S,D) -> q (B,S,H,hd), k, v (B,S,KV,hd), with ``rope`` tables
    (None: no rotation) applied to q and k: one product over the fused
    ``wqkv``, or three over the ``wq``, ``wk``, ``wv`` that
    ``fuse_block(..., fuse_qkv=False)`` keeps apart (the reference's
    ``qkv_proj``)."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    if "wqkv" in p:
        qkv = qkv_proj(x, p, cfg)
        qk = apply_rope_tables(qkv[:, :, :H + KV], rope)   # q and k together
        return qk[:, :, :H], qk[:, :, H:], qkv[:, :, H + KV:]
    q, k, v = (torch.einsum("bsd,dhk->bshk", x, p[w])
               for w in ("wq", "wk", "wv"))
    if p["bq"] is not None:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return apply_rope_tables(q, rope), apply_rope_tables(k, rope), v


def _softmax(logits):
    """Softmax over the last (key) dim. Under sharding rules it is written
    out (max, exp, sum), so that keys sharded over the mesh (the
    context-parallel cache) reduce their max and sum across it, as XLA
    partitions it, where DTensor's softmax would gather the logits."""
    if current_rules() is None:
        return torch.softmax(logits, dim=-1)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _write(buf, new, at: int):
    """``buf[:, at:at + S] = new`` in place, for a dense cache buffer
    (B, Smax, ...). Under sharding rules, as a select over the whole
    buffer: a slice of a sequence-sharded ``DTensor`` is a gathered copy,
    and a write into it would be lost."""
    S = new.shape[1]
    if current_rules() is None:
        buf[:, at:at + S] = new
        return
    pos = replicate(torch.arange(buf.shape[1], device=buf.device))
    hit = (pos >= at) & (pos < at + S)
    spread = torch.index_select(new, 1, torch.clamp(pos - at, 0, S - 1))
    hit = hit.reshape((1, -1) + (1,) * (buf.ndim - 2))
    buf.copy_(torch.where(hit, spread.to(buf.dtype), buf))


def mha(q, k, v, mask, *, softcap: float = 0.0):
    """q (B,Tq,H,hd), k/v (B,Tk,KV,hd), mask broadcastable to (B,H,Tq,Tk)
    or, with GQA, (B,KV,G,Tq,Tk).

    GQA is computed grouped (no materialized kv-head repeat): K/V stay at
    their stored width."""
    B, Tq, H, hd = q.shape
    KV = k.shape[2]
    if KV == H:
        logits = einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
        logits = _softcap(logits / math.sqrt(hd), softcap)
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
        w = _softmax(logits).to(q.dtype)
        return einsum("bhqk,bkhd->bqhd", w, v)
    G = H // KV
    qg = q.reshape(B, Tq, KV, G, hd)
    logits = einsum("bqcgd,bkcd->bcgqk", qg, k).to(torch.float32)
    logits = _softcap(logits / math.sqrt(hd), softcap)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    w = _softmax(logits).to(q.dtype)
    out = einsum("bcgqk,bkcd->bqcgd", w, v)
    return out.reshape(B, Tq, H, hd)


def quant_kv(x):
    """Symmetric per-(token, head) int8 quantization: (q8, scale)."""
    x32 = x.to(torch.float32)
    scale = torch.clamp(x32.abs().amax(dim=-1, keepdim=True), min=1e-6) / \
        127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def _maybe_dequant(x, compute_dtype, scale=None):
    if x.dtype == torch.int8:
        return (x.to(torch.float32) * scale).to(compute_dtype)
    return x.to(compute_dtype)


def attention_block(x, p, cfg: ModelConfig, *, rope, q_start: int = 0,
                    window: int = 0, cache=None, kv_override=None,
                    is_causal: bool = True, causal_impl: str = "kernel"):
    """Dense attention sub-block (norm handled by the caller).

    x: (B, S, D); p: the layer's ``fuse_attn`` weights; rope:
    ``rope_tables`` for these positions (not applied with
    ``kv_override``). cache: None (the whole sequence at once, queries at
    positions ``q_start + i``) or the dense slot cache of one layer, a dict
    {k, v: (B, Smax, KV, hd) bf16 or int8, [k_scale, v_scale: (B, Smax,
    KV, 1) f32 for int8], idx: tokens written so far}. The chunk's K/V are
    written at ``[idx, idx+S)`` in place — clamped to ``Smax - S`` as
    JAX's ``dynamic_update_slice`` clamps it — and the queries, at
    positions ``idx + i`` (the unclamped ``idx``), attend over the first
    ``min(idx+S, Smax)`` keys. Causal attention, cached or not, goes
    through ``kernels.ops.prefill_attention`` (the hand-written kernel on
    the card); cross attention (``kv_override``) and the bidirectional
    encoder (``is_causal=False``) use ``mha``, as in the JAX package.
    ``causal_impl="mha"`` sends causal attention through ``mha`` with
    ``causal_mask`` instead — the cache-less one over the chunk, the
    cached one over the whole buffer: the JAX package's non-kernel
    branches, the ones its training differentiates (no kernel has a
    backward) and its dry-run lowers.

    Returns (out (B, S, D), new_cache): the cache dict with ``idx + S``,
    sharing the updated buffers.
    """
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.hd
    q, k, v = qkv_rope(x, p, cfg, rope if kv_override is None else None)
    q = shard_act(q, "batch", "seq", "heads", None)
    softcap = cfg.logit_softcap
    new_cache = None
    if cache is not None:
        idx = int(cache["idx"])
        ck, cv = cache["k"], cache["v"]
        Smax = ck.shape[1]
        if S > Smax:
            raise ValueError(f"a chunk of {S} tokens does not fit a cache of "
                             f"{Smax}")
        at, n = min(idx, Smax - S), min(idx + S, Smax)
        new_cache = dict(cache, idx=idx + S)
        ks = vs = None
        if ck.dtype == torch.int8:
            (k, k_sc), (v, v_sc) = quant_kv(k), quant_kv(v)
            _write(cache["k_scale"], k_sc, at)
            _write(cache["v_scale"], v_sc, at)
            ks, vs = cache["k_scale"][:, :n], cache["v_scale"][:, :n]
        _write(ck, k, at)
        _write(cv, v, at)
        if causal_impl == "mha":
            # entries beyond idx+S are unwritten -> masked off by causality
            if ks is not None:
                ks, vs = cache["k_scale"], cache["v_scale"]
            mask = replicate(causal_mask(idx, S, Smax, window,
                                         device=x.device))
            out = mha(q, _maybe_dequant(ck, q.dtype, ks),
                      _maybe_dequant(cv, q.dtype, vs), mask, softcap=softcap)
        else:
            out = kops.prefill_attention(
                q.contiguous(), _maybe_dequant(ck[:, :n], q.dtype, ks),
                _maybe_dequant(cv[:, :n], q.dtype, vs), q_start=idx,
                window=window, softcap=softcap)
    elif kv_override is not None:
        ck, cv = kv_override  # cross attention (whisper decoder)
        mask = replicate(torch.ones((S, ck.shape[1]), dtype=torch.bool,
                                    device=x.device))
        out = mha(q, ck.to(q.dtype), cv.to(q.dtype), mask, softcap=softcap)
    elif is_causal and causal_impl == "mha":
        mask = replicate(causal_mask(q_start, S, S, window, device=x.device))
        out = mha(q, k, v, mask, softcap=softcap)
    elif is_causal:
        out = kops.prefill_attention(q.contiguous(), k, v, q_start=q_start,
                                     window=window, softcap=softcap)
    else:
        mask = replicate(torch.ones((S, S), dtype=torch.bool,
                                    device=x.device))
        out = mha(q, k, v, mask, softcap=softcap)
    out = out.reshape(B, S, H * hd) @ p["wo"]
    return shard_act(out, "batch", "seq", "embed_act"), new_cache


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
    q, k, v = qkv_rope(x, p, cfg, rope)
    q = shard_act(q, "batch", "seq", "heads", None)
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
    out = out.reshape(B, S, H * hd) @ p["wo"]
    return shard_act(out, "batch", "seq", "embed_act"), store


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_block(x, p):
    """SwiGLU MLP."""
    h = F.silu(x @ p["wi"]) * (x @ p["wg"])
    h = shard_act(h, "batch", "seq", "mlp")
    # the reference leaves this all-reduce to XLA's propagation; a DTensor
    # product over the sharded mlp dim stays a partial sum until asked
    return shard_act(h @ p["wo"], "batch", "seq", "embed_act")


def gelu_mlp_block(x, p):
    """The encoder-decoder's two-matrix MLP, with JAX's default (tanh)
    GELU."""
    h = shard_act(F.gelu(x @ p["wi"], approximate="tanh"), "batch", "seq",
                  "mlp")
    return shard_act(h @ p["wo"], "batch", "seq", "embed_act")


def moe_route(x, router, cfg: ModelConfig, *, group_size: int = 512):
    """Routing of ``moe_block``: top-k experts per token, and each
    (token, k)'s slot in its expert, within groups of ``G = min(group_size,
    S)`` tokens taken along each row (the sequence padded to a multiple of
    G; padding tokens route and take slots too, after the row's real
    ones).

    x (B, S, D) -> dict with G, C (slots per expert: ``ceil(G*K/E *
    capacity_factor)``), pad, gates (g, G, E) f32 router softmax, topi /
    topw (g, G, K) (weights renormalised over the top k), pos (g, G, K)
    the slot in flattened (token, k) order, keep (g, G, K) ``pos < C``.
    """
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    G = min(group_size, S)
    pad = (-S) % G
    xg = _pad_seq(x, pad).reshape(-1, G, D)
    # router logits in f32, as the jitted JAX function computes them (XLA
    # keeps the bf16 product's f32 result for the f32 softmax; an eager
    # one rounds it to bf16 first, and some tokens then route elsewhere)
    logits = xg.to(torch.float32) @ router.to(torch.float32)
    gates = torch.softmax(logits, dim=-1)
    # a stable descending sort: ties go to the lower expert, as
    # jax.lax.top_k breaks them; over the groups the dispatch holds (under
    # the baseline rules every group, as the reference's top_k gathers its
    # gates over data)
    topi = torch.sort(shard_act(gates, "moe_group", None, None), dim=-1,
                      descending=True, stable=True)[1][..., :K]
    # the chosen gates, exactly, by a one-hot product (differentiable on a
    # sharded tensor, where torch 2.11's backward of sort is not)
    topw = (F.one_hot(topi, E).to(gates.dtype) * gates[..., None, :]).sum(-1)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    C = max(1, int(math.ceil(G * K / E * cfg.capacity_factor)))
    oh = F.one_hot(topi.reshape(topi.shape[0], G * K), E)   # (g, G*K, E)
    # slot within the expert: the (token, k) pairs before it that chose it
    pos = ((torch.cumsum(oh, dim=1) - oh) * oh).sum(-1).reshape(topi.shape)
    return {"G": G, "C": C, "pad": pad, "gates": gates, "topi": topi,
            "topw": topw, "pos": pos, "keep": pos < C}


def moe_block(x, p, cfg: ModelConfig, *, group_size: int = 512,
              dispatch: str = "index"):
    """Capacity-based top-k MoE: the JAX package's function. ``dispatch``
    picks how tokens reach their (expert, slot) rows and come back:
    "index" (serving and training) replaces the one-hot dispatch and
    combine einsums by index ops on the kept rows (an empty slot's expert
    output is exactly zero and enters no token's sum, as in the einsums);
    expert products run in the compute dtype, one batched product per
    weight over every group's slots; each token's K outputs are combined
    in f32 with the weights rounded to the compute dtype, then rounded
    once. "onehot" (the dry-run) is the reference's einsums themselves
    (``_moe_onehot``), which a sharded step runs with the reference's
    collectives.

    Returns (out (B, S, D), aux) with the Switch load-balance loss aux
    (f32 scalar)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    r = moe_route(x, p["router"], cfg, group_size=group_size)
    G, C, pad = r["G"], r["C"], r["pad"]
    xg = _pad_seq(x, pad).reshape(-1, G, D)
    if dispatch == "onehot":
        return _moe_onehot(x, xg, p, r, E), _moe_aux(r, E, K)
    if dispatch != "index":
        raise ValueError(f"dispatch {dispatch!r}: 'index' or 'onehot'")
    g = xg.shape[0]
    topi, pos, keep = r["topi"], r["pos"], r["keep"]
    gi = replicate(torch.arange(g, device=x.device)[:, None, None]
                   ).expand_as(topi)
    si = replicate(torch.arange(G, device=x.device)[None, :, None]
                   ).expand_as(topi)
    # every (token, k) is written, a dropped one into a spare slot C that
    # no product reads: no host sync on the number kept
    xe = x.new_zeros((E, g, C + 1, D))
    xe[topi, gi, torch.where(keep, pos, C)] = xg[gi, si]
    # 'moe_group' maps to the data axis under the moe_data option: the
    # dispatched tokens stay batch-sharded instead of replicated
    xe = shard_act(xe[:, :, :C], "experts", "moe_group", None, "embed_act")
    xe = xe.reshape(E, g * C, D)
    h = F.silu(torch.bmm(xe, p["wi"])) * torch.bmm(xe, p["wg"])
    h = shard_act(h, "experts", "moe_group", "expert_mlp")
    eo = torch.bmm(h, p["wo"]).reshape(E, g, C, D)
    w = (r["topw"] * keep).to(x.dtype).to(torch.float32)   # (g, G, K)
    sel = eo[topi, gi, torch.clamp(pos, max=C - 1)].to(torch.float32)
    y = (sel * w[..., None]).sum(2).to(x.dtype)
    # as in mlp_block: the expert products' partial sums, resolved here
    y = shard_act(y.reshape(B, S + pad, D)[:, :S], "batch", "seq",
                  "embed_act")
    return y, _moe_aux(r, E, K)


def _pad_seq(x, pad: int):
    """x (B, S, D) with ``pad`` zero tokens appended along the sequence
    (a concatenation, which a sharded tensor takes as it is)."""
    if not pad:
        return x
    B, _, D = x.shape
    return torch.cat([x, x.new_zeros((B, pad, D))], dim=1)


def _moe_onehot(x, xg, p, r, E: int):
    """``moe_block``'s expert pass as the reference writes it: the
    (g, G, E, C) one-hot dispatch built in f32 from ``moe_route``'s
    choice, the dispatch einsum in f32, the expert products and the
    combine einsum in the compute dtype, with the reference's
    ``shard_act`` points (the dispatched tokens cross the mesh in f32
    before they are rounded, as XLA moves them)."""
    B, S, D = x.shape
    G, C, pad = r["G"], r["C"], r["pad"]
    f32 = torch.float32
    oh = F.one_hot(r["topi"], E).to(f32)                    # (g, G, K, E)
    # a (token, k) past its expert's capacity matches no slot: dropped
    slot = (r["pos"][..., None] == replicate(
        torch.arange(C, device=x.device))).to(f32)          # (g, G, K, C)
    disp = einsum("gske,gskc->gsec", oh, slot)              # (g, G, E, C)
    combine = disp * (oh * r["topw"][..., None]).sum(2)[..., None]
    xe = einsum("gsd,gsec->gecd", xg.to(f32), disp)
    xe = shard_act(xe, "moe_group", "experts", None, "embed_act").to(x.dtype)
    h = F.silu(einsum("gecd,edf->gecf", xe, p["wi"])) * \
        einsum("gecd,edf->gecf", xe, p["wg"])
    h = shard_act(h, "moe_group", "experts", None, "expert_mlp")
    # the expert products' partial sums, resolved on this rank's groups
    # before the combine, as XLA resolves them
    eo = shard_act(einsum("gecf,efd->gecd", h, p["wo"]), "batch",
                   "experts", None, "embed_act")
    y = einsum("gecd,gsec->gsd", eo, combine.to(eo.dtype))
    y = y.to(x.dtype).reshape(B, S + pad, D)[:, :S]
    return shard_act(y, "batch", "seq", "embed_act")


def _moe_aux(r, E: int, K: int):
    """The Switch load-balance loss of ``moe_route``'s choice (f32)."""
    oh = F.one_hot(r["topi"], E).to(torch.float32)          # (g, G, K, E)
    me = oh[..., 0, :] if K == 1 else oh.mean(2)
    density, density_proxy = me.mean(1), r["gates"].mean(1)
    # the mean over groups as a sum and a division: over groups sharded on
    # the mesh it stays a partial sum (torch 2.11 cannot add a partial
    # mean to one)
    per_group = (density * density_proxy).sum(-1)
    aux = per_group.sum() / per_group.numel() * (E ** 2) / (E * 1.0)
    return aux.to(torch.float32)
