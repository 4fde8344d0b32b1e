"""Unified multi-family model: parameter declarations for every block type,
and the forward over the batched paged KV cache.

Layer stacking: the decoder pattern is decomposed into (period, repeats)
stages; per stage, weights are stacked on a leading ``layers`` dim (the
JAX package's layout, so weights carry over path for path), and the
forward walks the repeats with a Python loop. Only the paged-cache serving
forward is ported so far; the dense slot cache, sliding-window, MoE, SSM,
xLSTM and encoder-decoder forwards are listed in ROADMAP.md.
"""
from __future__ import annotations

import math

import torch

from . import layers as L
from .config import (ATTN, ATTN_L, ATTN_MOE, DEC_ATTN, ENC_ATTN, MAMBA,
                     MAMBA_MOE, MLSTM, MOE_BLOCKS, SLSTM, ModelConfig)
from .params import ParamDecl, decl, tree_map, tree_map_decls
from .rope import rope_tables

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


def layer_params(params, cfg: ModelConfig) -> list:
    """Per-stage, per-block lists of each layer's weights as the forward
    uses them: ``out[si][f"b{i}"][li]`` is layer ``li``'s ``fuse_block``
    dict (views of the stacked weights where the layout allows, small
    copies where it regroups). The executor builds them once at load."""
    out = []
    for (period, reps), stage in zip(cfg.stages(), params["stages"]):
        per = {}
        for bi, bt in enumerate(period):
            stacked = stage[f"b{bi}"]
            views = [tree_map(lambda a, li=li: a[li], stacked,
                              is_leaf=torch.is_tensor) for li in range(reps)]
            per[f"b{bi}"] = [L.fuse_block(v, cfg) if bt == ATTN else v
                             for v in views]
        out.append(per)
    return out


# ---------------------------------------------------------------------------
# Forward (paged cache)
# ---------------------------------------------------------------------------

def _apply_paged_block(x, bp, bt, cfg, *, rope, store, ctx, attn_impl):
    """Attention block over the paged cache: (x, store)."""
    if bt != ATTN:
        # ATTN_MOE's moe_block waits for its slice (ROADMAP.md, queue 1)
        raise NotImplementedError(
            f"paged forward of block type {bt!r} is not ported yet "
            "(ROADMAP.md: MoE moe_block)")
    h = L.rms_norm_scaled(x, bp["ln1"], cfg.norm_eps)
    attn_out, store = L.paged_attention_block(
        h, bp, cfg, rope=rope, store=store, ctx=ctx, impl=attn_impl)
    x = x + attn_out
    h = L.rms_norm_scaled(x, bp["ln2"], cfg.norm_eps)
    return x + L.mlp_block(h, bp["mlp"]), store


def forward(params, cfg: ModelConfig, tokens, *, positions, cache=None,
            last_pos=None, attn_impl="gather", layers=None):
    """Forward over the batched paged KV cache.

    tokens: (B, S) int. positions: (B,S) or (B,S,3) for mrope.
    params: the ``model_decls`` tree, already in the compute dtype (see
      ``cast_params``); ``layers`` optionally gives its ``layer_params``
      so a call does not regroup the weights again.
    cache: the paged cache — a dict with "stages" (per-stage
      {"b<i>": PagedStackStore}, written in place), "block_table"
      (B, max_pages), "lengths" (B,) context written per row, and
      "new_lens" (B,) valid new tokens per row. attn_impl ('gather' |
      'kernel') picks the attention backend (see
      layers.paged_attention_block).
    last_pos: (B,) int — gather this position per row before the lm_head
      (ragged packed prefill: only each row's last real token needs logits).
    Returns (logits (B,S,V), new_cache, aux_loss).
    """
    if cache is None or "block_table" not in cache:
        raise NotImplementedError(
            "only the paged-cache forward is ported (ROADMAP.md: dense "
            "slot cache and attention_block)")
    if not paged_supported(cfg):
        raise NotImplementedError(
            f"{cfg.name}: block pattern outside the paged protocol "
            "(ROADMAP.md: SSM/xLSTM/whisper, sliding window)")
    B, S = tokens.shape
    dev = tokens.device
    embed = params["embed"]
    x = embed[tokens.long()]
    rope = rope_tables(positions, cfg.hd, cfg.rope_theta, cfg.rope_style)
    bt_, lengths, new_lens = (cache["block_table"], cache["lengths"],
                              cache["new_lens"])
    # per-step geometry, the same for every layer
    ctx = {"block_table": bt_, "lengths": lengths, "new_lens": new_lens,
           "totals": lengths + new_lens}
    if layers is None:
        layers = layer_params(params, cfg)
    for si, (period, reps) in enumerate(cfg.stages()):
        stores = cache["stages"][si]
        slots = {name: st.slots(bt_, lengths, new_lens, S)
                 for name, st in stores.items()}
        for li in range(reps):
            for bi, bt in enumerate(period):
                name = f"b{bi}"
                x, stores[name] = _apply_paged_block(
                    x, layers[si][name][li], bt, cfg, rope=rope,
                    store=stores[name],
                    ctx=dict(ctx, slots=slots[name], layer=li),
                    attn_impl=attn_impl)

    if last_pos is not None:
        # packed ragged prefill: each row's last real position only
        idx = last_pos.long()[:, None, None].expand(B, 1, x.shape[-1])
        x = torch.gather(x, 1, idx)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = embed.T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.to(x.dtype)
    new_cache = {"stages": cache["stages"], "block_table": bt_,
                 "lengths": ctx["totals"], "new_lens": new_lens}
    return logits, new_cache, torch.zeros((), dtype=torch.float32, device=dev)
