"""Unified multi-family model: parameter and cache declarations for every
block type, and the forward — attention and MoE decoders over the batched
paged KV cache; every family (attention, sliding window, MoE, Mamba,
xLSTM, the whisper encoder-decoder) over the dense slot cache or with no
cache.

Layer stacking: the decoder pattern is decomposed into (period, repeats)
stages; per stage, weights are stacked on a leading ``layers`` dim (the
JAX package's layout, so weights carry over path for path), and the
forward walks the repeats with a Python loop.
"""
from __future__ import annotations

import functools
import math
import operator

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import layers as L
from .config import (ATTN, ATTN_L, ATTN_MOE, DEC_ATTN, ENC_ATTN, MAMBA,
                     MAMBA_MOE, MLSTM, MOE_BLOCKS, SLSTM, ModelConfig)
from .params import ParamDecl, decl, init_params, tree_map, tree_map_decls
from .rope import rope_tables
from .sharding import replicate, shard_act, unshard
from .ssm import mamba_block
from .xlstm import mlstm_block, slstm_block

# ---------------------------------------------------------------------------
# Parameter declarations
# ---------------------------------------------------------------------------


def _attn_decls(cfg: ModelConfig, cross: bool = False) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    d = {
        "wq": decl((D, H, hd), ("embed", "heads", "head_dim")),
        "wk": decl((D, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wv": decl((D, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wo": decl((H, hd, D), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias and not cross:
        d.update({
            "bq": decl((H, hd), ("heads", "head_dim"), init="zeros"),
            "bk": decl((KV, hd), ("kv_heads", "head_dim"), init="zeros"),
            "bv": decl((KV, hd), ("kv_heads", "head_dim"), init="zeros"),
        })
    return d


def _norm_decl(cfg: ModelConfig, name: str) -> dict:
    d = {name: decl((cfg.d_model,), ("embed",),
                    init="zeros" if cfg.norm_style() == "rmsnorm" else "ones")}
    if cfg.norm_style() == "layernorm":
        d[name + "_b"] = decl((cfg.d_model,), ("embed",), init="zeros")
    return d


def _mlp_decls(cfg: ModelConfig) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    if cfg.is_encoder_decoder:  # whisper: 2-matrix GELU MLP
        return {"wi": decl((D, F), ("embed", "mlp")),
                "wo": decl((F, D), ("mlp", "embed"))}
    return {"wi": decl((D, F), ("embed", "mlp")),
            "wg": decl((D, F), ("embed", "mlp")),
            "wo": decl((F, D), ("mlp", "embed"))}


def _moe_decls(cfg: ModelConfig) -> dict:
    D, F, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": decl((D, E), ("embed", None), scale=0.02),
        "wi": decl((E, D, F), ("experts", "embed", "expert_mlp")),
        "wg": decl((E, D, F), ("experts", "embed", "expert_mlp")),
        "wo": decl((E, F, D), ("experts", "expert_mlp", "embed")),
    }


def _mamba_decls(cfg: ModelConfig) -> dict:
    D, DI, N, KC = cfg.d_model, cfg.d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    R = max(16, math.ceil(D / 16))
    return {
        "in_proj": decl((D, 2 * DI), ("embed", "inner")),
        "conv_w": decl((KC, DI), (None, "inner"), scale=0.5),
        "conv_b": decl((DI,), ("inner",), init="zeros"),
        "dt_down": decl((DI, R), ("inner", None)),
        "dt_up": decl((R, DI), (None, "inner")),
        "dt_bias": decl((DI,), ("inner",), init="zeros"),
        "wB": decl((DI, N), ("inner", "state")),
        "wC": decl((DI, N), ("inner", "state")),
        "A_log": decl((DI, N), ("inner", "state"), init="zeros"),
        "D_skip": decl((DI,), ("inner",), init="ones"),
        "out_proj": decl((DI, D), ("inner", "embed")),
    }


def _mlstm_decls(cfg: ModelConfig) -> dict:
    D, H = cfg.d_model, cfg.num_heads
    DI = int(cfg.xlstm_proj_factor * D)
    return {
        "up_proj": decl((D, 2 * DI), ("embed", "inner")),
        "wq": decl((DI, DI), ("inner", None)),
        "bq": decl((DI,), (None,), init="zeros"),
        "wk": decl((DI, DI), ("inner", None)),
        "bk": decl((DI,), (None,), init="zeros"),
        "wv": decl((DI, DI), ("inner", None)),
        "bv": decl((DI,), (None,), init="zeros"),
        "wi_g": decl((DI, H), ("inner", None), scale=0.02),
        "bi_g": decl((H,), (None,), init="zeros"),
        "wf_g": decl((DI, H), ("inner", None), scale=0.02),
        "bf_g": decl((H,), (None,), init="ones"),
        "down_proj": decl((DI, D), ("inner", "embed")),
    }


def _slstm_decls(cfg: ModelConfig) -> dict:
    D, H = cfg.d_model, cfg.num_heads
    hd = D // H
    F = int(4 * D / 3)
    d = {}
    for g in ("z", "i", "f", "o"):
        d["W" + g] = decl((H, hd, hd), ("heads", None, None))
        d["b" + g] = decl((H, hd), ("heads", None),
                          init="ones" if g == "f" else "zeros")
        d["R" + g] = decl((H, hd, hd), ("heads", None, None), scale=0.02)
    d["ff_up"] = decl((D, F), ("embed", "mlp"))
    d["ff_gate"] = decl((D, F), ("embed", "mlp"))
    d["ff_down"] = decl((F, D), ("mlp", "embed"))
    return d


def block_decls(cfg: ModelConfig, bt: str) -> dict:
    """Namespaced decl tree for one block: {'attn': {...}, 'mlp': {...}, ...}."""
    d = dict(_norm_decl(cfg, "ln1"))
    if bt in (ATTN, ATTN_L, ATTN_MOE, ENC_ATTN, DEC_ATTN):
        d["attn"] = _attn_decls(cfg)
        d.update(_norm_decl(cfg, "ln2"))
        if bt == DEC_ATTN:
            d["cross"] = _attn_decls(cfg, cross=True)
            d.update(_norm_decl(cfg, "ln_x"))
        if bt in MOE_BLOCKS:
            d["moe"] = _moe_decls(cfg)
        else:
            d["mlp"] = _mlp_decls(cfg)
    elif bt in (MAMBA, MAMBA_MOE):
        d["mamba"] = _mamba_decls(cfg)
        d.update(_norm_decl(cfg, "ln2"))
        if bt in MOE_BLOCKS:
            d["moe"] = _moe_decls(cfg)
        else:
            d["mlp"] = _mlp_decls(cfg)
    elif bt == MLSTM:
        d["core"] = _mlstm_decls(cfg)
    elif bt == SLSTM:
        d["core"] = _slstm_decls(cfg)
    else:
        raise ValueError(bt)
    return d


def _stack(d: dict, reps: int) -> dict:
    return tree_map_decls(
        lambda p: ParamDecl((reps,) + p.shape, ("layers",) + p.axes, p.init,
                            p.scale, p.dtype), d)


def model_decls(cfg: ModelConfig) -> dict:
    D, V = cfg.d_model, cfg.vocab_size
    out = {
        "embed": decl((V, D), ("vocab", "embed"), scale=0.02),
        "stages": [
            {f"b{i}": _stack(block_decls(cfg, bt), reps)
             for i, bt in enumerate(period)}
            for period, reps in cfg.stages()
        ],
    }
    out.update(_norm_decl(cfg, "final_norm"))
    if not cfg.tie_embeddings:
        out["lm_head"] = decl((D, V), ("embed", "vocab"), scale=0.02)
    if cfg.is_encoder_decoder:
        out["enc_stages"] = [
            {"b0": _stack(block_decls(cfg, ENC_ATTN), cfg.num_encoder_layers)}
        ]
        out.update({k + "_enc": v for k, v in _norm_decl(cfg, "final_norm").items()})
    return out


# ---------------------------------------------------------------------------
# Cache declarations (dense slot cache)
# ---------------------------------------------------------------------------

def cache_decls(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, window_cache: bool = False) -> dict:
    """Decl tree for the decode/prefill cache (dense JetStream-style layout)."""
    KV, hd = cfg.num_kv_heads, cfg.hd
    H = cfg.num_heads

    def attn_cache(bt):
        S = max_len
        if window_cache and bt == ATTN_L and cfg.sliding_window > 0:
            S = min(max_len, cfg.sliding_window)
        d = {
            "k": decl((batch, S, KV, hd), ("batch", "cache_seq", "kv_heads", None),
                      init="zeros", dtype=dtype),
            "v": decl((batch, S, KV, hd), ("batch", "cache_seq", "kv_heads", None),
                      init="zeros", dtype=dtype),
        }
        if dtype == torch.int8:  # per-(token, head) quantization scales
            for s in ("k_scale", "v_scale"):
                d[s] = decl((batch, S, KV, 1),
                            ("batch", "cache_seq", "kv_heads", None),
                            init="ones", dtype=torch.float32)
        if bt == DEC_ATTN:
            cross_dt = torch.bfloat16 if dtype == torch.int8 else dtype
            d["ck"] = decl((batch, cfg.encoder_seq, KV, hd),
                           ("batch", None, "kv_heads", None), init="zeros",
                           dtype=cross_dt)
            d["cv"] = decl((batch, cfg.encoder_seq, KV, hd),
                           ("batch", None, "kv_heads", None), init="zeros",
                           dtype=cross_dt)
        return d

    def block_cache(bt):
        if bt in (ATTN, ATTN_L, ATTN_MOE, DEC_ATTN):
            return attn_cache(bt)
        if bt in (MAMBA, MAMBA_MOE):
            return {
                "conv": decl((batch, cfg.mamba_d_conv - 1, cfg.d_inner),
                             ("batch", None, "inner"), init="zeros", dtype=dtype),
                "ssm": decl((batch, cfg.d_inner, cfg.mamba_d_state),
                            ("batch", "inner", "state"), init="zeros",
                            dtype=torch.float32),
            }
        if bt == MLSTM:
            DI = int(cfg.xlstm_proj_factor * cfg.d_model)
            hdi = DI // H
            return {
                "C": decl((batch, H, hdi, hdi), ("batch", "heads", None, None),
                          init="zeros", dtype=torch.float32),
                "n": decl((batch, H, hdi), ("batch", "heads", None),
                          init="zeros", dtype=torch.float32),
                "m": decl((batch, H), ("batch", "heads"), init="fill",
                          fill=-1e30, dtype=torch.float32),
            }
        if bt == SLSTM:
            hds = cfg.d_model // H
            return {k: decl((batch, H, hds), ("batch", "heads", None),
                            init="ones" if k == "n" else "zeros",
                            dtype=torch.float32)
                    for k in ("c", "n", "m", "h")}
        raise ValueError(bt)

    return {
        "stages": [
            {f"b{i}": _stack(block_cache(bt), reps) for i, bt in enumerate(period)}
            for period, reps in cfg.stages()
        ],
        "idx": decl((), (), init="zeros", dtype=torch.int32),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device="cpu") -> dict:
    """Materialise ``cache_decls`` (zeros, ones and fills: nothing is
    drawn) with its buffers on ``device``. ``idx`` stays a host tensor:
    the host reads it every step (the write offset and the queries'
    positions)."""
    decls = cache_decls(cfg, batch, max_len, dtype)
    tree = init_params({"stages": decls["stages"]}, None, device=device)
    tree["idx"] = torch.zeros((), dtype=torch.int32)
    return tree


def paged_supported(cfg: ModelConfig) -> bool:
    """True when every decoder block can use the paged-KV cache protocol
    (global causal attention, optionally MoE). SSM/xLSTM state and
    sliding-window / cross-attention KV keep the dense slot cache — their
    per-request footprint is constant or windowed, not paged."""
    if cfg.is_encoder_decoder:
        return False
    return all(bt in (ATTN, ATTN_MOE)
               for period, _ in cfg.stages() for bt in period)


def cast_params(params, dtype: torch.dtype):
    """Mixed precision, once at load: f32 master leaves -> ``dtype``
    (other dtypes stay). The forward computes in whatever the leaves
    hold, so the executor casts once instead of every call."""
    return tree_map(lambda a: a.to(dtype) if a.dtype == torch.float32
                    else a, params, is_leaf=torch.is_tensor)


def layer_params(params, cfg: ModelConfig, *, release: bool = False,
                 key: str = "stages", fuse_qkv: bool = True) -> list:
    """Per-stage, per-block lists of each layer's weights as the forward
    uses them: ``out[si][f"b{i}"][li]`` is layer ``li``'s ``fuse_block``
    dict (views of the stacked weights where the layout allows, small
    copies where it regroups). The executor builds them once at load.
    ``key="enc_stages"`` gives the encoder's (whisper).

    ``release`` drops each block's stacked q/k/v projections (and biases)
    from ``params`` once its layers are fused, so the fused copy does not
    double them (2.7 B parameters at gemma3-27b's widths); the forward
    then needs these lists. ``fuse_qkv`` goes to ``layers.fuse_block``."""
    stages = cfg.stages() if key == "stages" else \
        [((ENC_ATTN,), cfg.num_encoder_layers)]
    out = []
    for (period, reps), stage in zip(stages, params[key]):
        per = {}
        for bi, _bt in enumerate(period):
            stacked = stage[f"b{bi}"]
            # one unbind per stacked leaf, not one select per layer: under
            # autograd a select's backward writes a zeroed stacked-size
            # gradient for each layer (O(layers^2) traffic); unbind's
            # stacks the layers' gradients once
            parts = tree_map(lambda a: a.unbind(0), stacked,
                             is_leaf=torch.is_tensor)
            per[f"b{bi}"] = [
                L.fuse_block(tree_map(lambda t, li=li: t[li], parts,
                                      is_leaf=lambda t: isinstance(t, tuple)),
                             cfg, fuse_qkv=fuse_qkv)
                for li in range(reps)]
            if release and "attn" in stacked:
                for name in ("wq", "wk", "wv", "bq", "bk", "bv"):
                    stacked["attn"].pop(name, None)
        out.append(per)
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _ffn(x, bp, bt, cfg, moe_dispatch="index"):
    """The block's second half: norm ``ln2``, then the MoE (its
    ``dispatch`` route ``moe_dispatch``), the encoder-decoder's GELU MLP
    or the SwiGLU MLP, added to x; (x, aux)."""
    h = L.norm(x, bp, cfg, "ln2")
    if bt in MOE_BLOCKS:
        out, aux = L.moe_block(h, bp["moe"], cfg, dispatch=moe_dispatch)
        return x + out, aux
    if cfg.is_encoder_decoder:
        return x + L.gelu_mlp_block(h, bp["mlp"]), None
    return x + L.mlp_block(h, bp["mlp"]), None


def _apply_paged_block(x, bp, bt, cfg, *, rope, store, ctx, attn_impl):
    """ATTN or ATTN_MOE block over the paged cache: (x, store, aux)."""
    if bt not in (ATTN, ATTN_MOE):
        raise NotImplementedError(
            f"paged cache protocol does not support block type {bt!r}")
    h = L.norm(x, bp, cfg, "ln1")
    attn_out, store = L.paged_attention_block(
        h, bp, cfg, rope=rope, store=store, ctx=ctx, impl=attn_impl)
    x, aux = _ffn(x + attn_out, bp, bt, cfg)
    return x, store, aux


def _cross_attention(h, cp, cfg, cache, enc_out):
    """DEC_ATTN's cross attention over the encoder output's K/V: computed
    from ``enc_out`` when frames were given (and written into the slot's
    ``ck``/``cv``), else read from the slot cache, as the JAX package
    does (in serving no frames are passed, so a slot's zeroed cross K/V
    are read)."""
    if cache is not None and enc_out is None:
        ck, cv = cache["ck"], cache["cv"]
    else:
        ck = torch.einsum("btd,dhk->bthk", enc_out, cp["wk"])
        cv = torch.einsum("btd,dhk->bthk", enc_out, cp["wv"])
        if cache is not None:
            cache["ck"].copy_(ck)
            cache["cv"].copy_(cv)
    # the reference's cross attention is its attention_block with the
    # encoder's K/V: the same annotations
    q = shard_act(torch.einsum("bsd,dhk->bshk", h, cp["wq"]), "batch", "seq",
                  "heads", None)
    mask = replicate(torch.ones((h.shape[1], ck.shape[1]), dtype=torch.bool,
                                device=h.device))
    out = L.mha(q, ck.to(q.dtype), cv.to(q.dtype), mask, softcap=0.0)
    return shard_act(torch.einsum("bshk,hkd->bsd", out, cp["wo"]), "batch",
                     "seq", "embed_act")


def _apply_attnish(x, bp, bt, cfg, *, rope, q_start, cache, enc_out=None,
                   causal_impl="kernel", moe_dispatch="index"):
    """Attention-family block (ATTN, ATTN_L, ATTN_MOE, ENC_ATTN, DEC_ATTN)
    with the dense slot cache of this layer (written in place) or none:
    (x, aux)."""
    h = L.norm(x, bp, cfg, "ln1")
    attn_out, _ = L.attention_block(
        h, bp, cfg, rope=rope, q_start=q_start, window=cfg.window_for(bt),
        cache=cache, is_causal=bt != ENC_ATTN, causal_impl=causal_impl)
    x = x + attn_out
    if bt == DEC_ATTN:
        h = L.norm(x, bp, cfg, "ln_x")
        x = x + _cross_attention(h, bp["cross"], cfg, cache, enc_out)
    return _ffn(x, bp, bt, cfg, moe_dispatch)


def _write_state(cache, new):
    """Copy a recurrent block's new state into its slot cache, in place."""
    if cache is not None:
        for k, a in new.items():
            cache[k].copy_(a)


def _apply_block(x, bp, bt, cfg, *, rope, q_start, cache, enc_out,
                 causal_impl="kernel", moe_dispatch="index", scan="loop"):
    """One block on the dense slot cache or with none: (x, aux or None)."""
    bp = unshard(bp)
    if bt in (MAMBA, MAMBA_MOE):
        h = L.norm(x, bp, cfg, "ln1")
        state = None if cache is None else \
            {k: cache[k] for k in ("conv", "ssm")}
        out, new = mamba_block(h, bp["mamba"], cfg, cache=state)
        _write_state(state, new)
        return _ffn(x + out, bp, bt, cfg, moe_dispatch)
    if bt in (MLSTM, SLSTM):
        block = mlstm_block if bt == MLSTM else slstm_block
        out, new = block(L.norm(x, bp, cfg, "ln1"), bp["core"], cfg,
                         cache=cache, scan=scan)
        _write_state(cache, new)
        return x + out, None
    return _apply_attnish(x, bp, bt, cfg, rope=rope, q_start=q_start,
                          cache=cache, enc_out=enc_out,
                          causal_impl=causal_impl, moe_dispatch=moe_dispatch)


def dense_supported(cfg: ModelConfig) -> bool:
    """True when the port runs this model on the dense slot cache or with
    no cache: every block type of the ten archs (attention, sliding
    window, MoE, Mamba, xLSTM and the encoder-decoder)."""
    known = {ATTN, ATTN_L, ATTN_MOE, MAMBA, MAMBA_MOE, MLSTM, SLSTM,
             DEC_ATTN}
    return all(bt in known for period, _ in cfg.stages() for bt in period)


def _sinusoid_at(positions, D: int):
    """positions (B, S) -> (B, S, D) sinusoidal embedding, f32."""
    pos = positions.to(torch.float32)[..., None]
    dim = torch.arange(0, D, 2, dtype=torch.float32, device=positions.device)
    ang = pos / replicate(torch.pow(
        torch.tensor(10000.0, device=positions.device), dim / D))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _final_norm(x, params, cfg, suffix=""):
    w = unshard(params["final_norm" + suffix])
    if cfg.norm_style() == "layernorm":
        return L.layer_norm(x, w, unshard(params["final_norm_b" + suffix]),
                            cfg.norm_eps)
    return L.rms_norm(x, w, cfg.norm_eps)


def encode(params, cfg: ModelConfig, frames, *, fuse_qkv: bool = True):
    """Whisper encoder over stub conv-frontend frame embeddings (B, T, D):
    sinusoidal positions, the bidirectional ENC_ATTN blocks (attention
    through ``mha``), the final LayerNorm."""
    B, T, D = frames.shape
    pos = replicate(torch.arange(T, device=frames.device)[None])
    x = frames + _sinusoid_at(pos, D).to(frames.dtype)
    rope = rope_tables(pos, cfg.hd, cfg.rope_theta, cfg.rope_style)
    for bp in layer_params(params, cfg, key="enc_stages",
                           fuse_qkv=fuse_qkv)[0]["b0"]:
        x, _ = _apply_attnish(x, unshard(bp), ENC_ATTN, cfg, rope=rope,
                              q_start=0, cache=None)
    return _final_norm(x, params, cfg, "_enc")


def forward(params, cfg: ModelConfig, tokens, *, positions=None,
            mm_embeds=None, enc_frames=None, cache=None, q_start=0,
            last_only=False, last_pos=None, attn_impl="gather", layers=None,
            causal_impl="kernel", remat=False, fuse_qkv=True,
            moe_dispatch="index", scan="loop"):
    """Unified forward.

    tokens: (B, S) int. positions: (B,S) or (B,S,3) for mrope; default
      ``q_start + arange(S)``.
    mm_embeds: (B, N_mm, D) stub patch/frame embeddings (VLM) — replace the
      first N_mm token embeddings.
    enc_frames: (B, T_enc, D) stub audio frames (whisper): encoded, and the
      decoder's cross attention reads them (writing their K/V into a dense
      cache); without them it reads the cache's ``ck``/``cv``.
    params: the ``model_decls`` tree, already in the compute dtype (see
      ``cast_params``); ``layers`` optionally gives its ``layer_params``
      so a call does not regroup the weights again.
    cache: None (the whole sequence, queries at ``q_start + i``); the
      dense slot cache from ``init_cache`` (``"stages"`` and ``"idx"``;
      its buffers — attention K/V, Mamba and xLSTM state — are written in
      place); OR the paged cache of the batched serving path — a dict
      with "stages" (per-stage {"b<i>": PagedStackStore}, written in
      place), "block_table" (B, max_pages), "lengths" (B,) context written
      per row, and "new_lens" (B,) valid new tokens per row (ATTN and
      ATTN_MOE decoders only, ``paged_supported``). attn_impl ('gather' |
      'kernel') picks the paged attention backend (see
      layers.paged_attention_block).
    causal_impl: the causal attention with no cache or over the dense
      cache — 'kernel' (default, every serving call) through
      ``kernels.ops.prefill_attention``, or 'mha' through ``layers.mha``
      with a causal mask (over the whole buffer of a dense cache), the JAX
      package's non-kernel branches: the ones training differentiates,
      since no kernel has a backward (``kernels.ops`` raises under
      autograd), and the dry-run runs on its mesh.
    fuse_qkv: False keeps each layer's q, k and v projections apart
      (``layers.fuse_block``), for the dry-run: concatenating head-sharded
      weights would gather them.
    moe_dispatch: the MoE blocks' route, ``layers.moe_block``'s
      ``dispatch``: "index" (default) or the reference's one-hot einsums,
      "onehot" (the dry-run).
    scan: the xLSTM blocks' recurrence, ``xlstm.recurrence``'s ``mode``:
      "loop" (default, every step) or "once" (the dry-run: the first and
      last steps, and one middle step counted once a middle token).
    remat: recompute each decoder block's activations in the backward
      (``torch.utils.checkpoint`` over each layer's block, as the JAX
      package's ``jax.checkpoint`` over each scan step); cache-less only.
    last_pos: (B,) int — gather this position per row before the lm_head
      (ragged packed prefill: only each row's last real token needs
      logits). last_only: the final position only (serving prefill).
    Returns (logits (B,S,V), new_cache_or_None, aux_loss): the MoE
    load-balance loss summed over layers (f32 scalar); a dense
    ``new_cache`` shares the cache's buffers, with ``idx`` advanced by S.
    """
    paged = cache is not None and "block_table" in cache
    if paged and not paged_supported(cfg):
        raise NotImplementedError(
            f"{cfg.name}: block pattern outside the paged protocol "
            "(sliding window, SSM/xLSTM state, cross attention: the dense "
            "slot cache)")
    if not dense_supported(cfg):
        raise ValueError(f"{cfg.name}: unknown block type in {cfg.stages()}")
    if causal_impl not in ("kernel", "mha"):
        raise ValueError(f"causal_impl {causal_impl!r}: 'kernel' or 'mha'")
    if remat and cache is not None:
        raise ValueError("remat is for the cache-less forward (training)")
    B, S = tokens.shape
    dev = tokens.device
    if positions is None:
        positions = replicate(
            (q_start + torch.arange(S, device=dev))[None].expand(B, S))
    # under FSDP rules the table is gathered over data first, for the
    # lookup (its rows then meet batch-sharded tokens) and a tied head
    embed = unshard(params["embed"])
    # the lookup from a vocab-sharded table leaves partial sums: resolve
    # them before the stub embeddings go in
    x = shard_act(F.embedding(tokens.long(), embed), "batch", "seq",
                  "embed_act")
    if mm_embeds is not None:
        # stub patch/frame embeddings replace the first N_mm token embeds
        # (out of place: a sharded tensor's gradient does not survive an
        # in-place write into it)
        x = torch.cat([mm_embeds.to(x.dtype), x[:, mm_embeds.shape[1]:]],
                      dim=1)
    if cfg.is_encoder_decoder:
        x = x + _sinusoid_at(positions[..., 0] if positions.ndim == 3
                             else positions, cfg.d_model).to(x.dtype)
    enc_out = None
    if cfg.is_encoder_decoder and enc_frames is not None:
        enc_out = encode(params, cfg, enc_frames.to(x.dtype),
                         fuse_qkv=fuse_qkv)
    rope = rope_tables(positions, cfg.hd, cfg.rope_theta, cfg.rope_style)
    if layers is None:
        layers = layer_params(params, cfg, fuse_qkv=fuse_qkv)
    auxes = []      # the MoE blocks' load-balance losses
    if paged:
        bt_, lengths, new_lens = (cache["block_table"], cache["lengths"],
                                  cache["new_lens"])
        # per-step geometry, the same for every layer
        ctx = {"block_table": bt_, "lengths": lengths, "new_lens": new_lens,
               "totals": lengths + new_lens}
        for si, (period, reps) in enumerate(cfg.stages()):
            stores = cache["stages"][si]
            slots = {name: st.slots(bt_, lengths, new_lens, S)
                     for name, st in stores.items()}
            for li in range(reps):
                for bi, bt in enumerate(period):
                    name = f"b{bi}"
                    x, stores[name], a = _apply_paged_block(
                        x, layers[si][name][li], bt, cfg, rope=rope,
                        store=stores[name],
                        ctx=dict(ctx, slots=slots[name], layer=li),
                        attn_impl=attn_impl)
                    if a is not None:
                        auxes.append(a)
        new_cache = {"stages": cache["stages"], "block_table": bt_,
                     "lengths": ctx["totals"], "new_lens": new_lens}
    else:
        idx = int(cache["idx"]) if cache is not None else None
        for si, (period, reps) in enumerate(cfg.stages()):
            for li in range(reps):
                for bi, bt in enumerate(period):
                    name = f"b{bi}"
                    blk = None
                    if cache is not None:
                        blk = {k: a[li] for k, a in
                               cache["stages"][si][name].items()}
                        blk["idx"] = idx
                    kw = dict(rope=rope, q_start=q_start, cache=blk,
                              enc_out=enc_out, causal_impl=causal_impl,
                              moe_dispatch=moe_dispatch, scan=scan)
                    if remat:
                        x, a = checkpoint(_apply_block, x,
                                          layers[si][name][li], bt, cfg,
                                          use_reentrant=False, **kw)
                    else:
                        x, a = _apply_block(x, layers[si][name][li], bt,
                                            cfg, **kw)
                    if a is not None:
                        auxes.append(a)
        new_cache = None if cache is None else {
            "stages": cache["stages"],
            "idx": torch.tensor(idx + S, dtype=torch.int32)}

    aux = functools.reduce(operator.add, auxes) if auxes else replicate(
        torch.zeros((), dtype=torch.float32, device=dev))
    if last_pos is not None:
        # packed ragged prefill: each row's last real position only
        idx_ = last_pos.long()[:, None, None].expand(B, 1, x.shape[-1])
        x = torch.gather(x, 1, idx_)
    elif last_only:
        x = x[:, -1:]  # serving prefill: lm_head on the final position only
    x = _final_norm(x, params, cfg)
    head = unshard(embed.T if cfg.tie_embeddings else params["lm_head"])
    logits = shard_act(x @ head.to(x.dtype), "batch", "seq", "vocab")
    return logits, new_cache, aux
