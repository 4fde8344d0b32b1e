"""Analytic FLOPs / HBM-bytes model for the roofline analysis.

The reference package's model, unchanged but for the hardware constants
(an H100 SXM5's). Every layer's einsum inventory is ours, so this counts
the compiled-equivalent FLOPs of a step exactly (incl. remat recompute, TP
head padding, MoE capacity + dispatch overhead); the dry-run
(``launch/dryrun.py``) records it beside the FLOPs and collectives it
counts on the simulated mesh, and both packages' dry-runs write the same
numbers here, so their records compare.

All numbers are GLOBAL (whole cluster, one step); divide by device count
for per-device terms.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.config import (ATTN, ATTN_L, ATTN_MOE, DEC_ATTN,
                                 MAMBA, MAMBA_MOE, MLSTM, MOE_BLOCKS, SLSTM,
                                 ModelConfig)
from repro_torch.models.params import param_count
from repro_torch.models.transformer import model_decls

BF16 = 2
F32 = 4


def _attn_layer_flops(cfg: ModelConfig, tokens: int, ctx: int, window: int,
                      cross_tokens: int = 0) -> float:
    """Forward FLOPs for one attention layer over `tokens` new tokens with
    average attended context `ctx` (already window-clamped by caller)."""
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    qkv = 2 * tokens * D * (H + 2 * KV) * hd
    attn = 4 * tokens * ctx * H * hd            # scores + weighted sum
    out = 2 * tokens * H * hd * D
    cross = 0.0
    if cross_tokens:
        cross = 2 * tokens * D * H * hd * 2 + 4 * tokens * cross_tokens * H * hd
    return qkv + attn + out + cross


def _mlp_flops(cfg: ModelConfig, tokens: int) -> float:
    mats = 2 if cfg.is_encoder_decoder else 3   # gelu-mlp vs swiglu
    return 2 * tokens * cfg.d_model * cfg.d_ff * mats


def _moe_flops(cfg: ModelConfig, tokens: int, group: int = 512) -> float:
    D, F, E, K = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.experts_per_token
    cf = cfg.capacity_factor
    router = 2 * tokens * D * E
    # capacity per group C = G*K*cf/E; expert matmuls over E*C slots
    expert = 2 * tokens * K * cf * D * F * 3
    dispatch = 2 * 2 * tokens * K * cf * E * D  # dispatch + combine einsums
    return router + expert + dispatch


def _mamba_flops(cfg: ModelConfig, tokens: int) -> float:
    D, DI, N = cfg.d_model, cfg.d_inner, cfg.mamba_d_state
    R = max(16, -(-D // 16))
    proj = 2 * tokens * D * 2 * DI + 2 * tokens * DI * D
    conv = 2 * tokens * cfg.mamba_d_conv * DI
    dt = 2 * tokens * DI * R * 2
    bc = 2 * tokens * DI * N * 2
    scan = 10 * tokens * DI * N                 # elementwise recurrence
    return proj + conv + dt + bc + scan


def _mlstm_flops(cfg: ModelConfig, tokens: int) -> float:
    D = cfg.d_model
    DI = int(cfg.xlstm_proj_factor * D)
    hd = DI // cfg.num_heads
    proj = 2 * tokens * D * 2 * DI + 2 * tokens * DI * D
    qkv = 3 * 2 * tokens * DI * DI
    rec = 8 * tokens * DI * hd                  # C update + readout per head
    return proj + qkv + rec


def _slstm_flops(cfg: ModelConfig, tokens: int) -> float:
    D = cfg.d_model
    hd = D // cfg.num_heads
    gates = 8 * 2 * tokens * D * hd             # 4 input + 4 recurrent blocks
    ffn = 2 * tokens * D * int(4 * D / 3) * 3
    return gates + ffn


@dataclass
class Costs:
    flops: float          # compiled-equivalent global FLOPs (one step)
    hbm_bytes: float      # global HBM traffic (one step)
    model_flops: float    # 6*N*D (train) / 2*N*D (inference), N_active for MoE
    kv_cache_bytes: float


def _active_params(cfg: ModelConfig) -> float:
    """Parameter count with MoE experts scaled to experts_per_token."""
    total = param_count(model_decls(cfg))
    if cfg.num_experts == 0:
        return float(total)
    # subtract inactive expert weights
    moe_layers = sum(1 for i in range(cfg.num_layers) if cfg.is_moe_layer(i))
    expert_params = 3 * cfg.d_model * cfg.d_ff
    inactive = moe_layers * (cfg.num_experts - cfg.experts_per_token) * expert_params
    return float(total - inactive)


def analytic_costs(cfg: ModelConfig, kind: str, seq: int, batch: int,
                   *, remat: bool = True, kv_dtype_bytes: int = BF16,
                   window_cache: bool = False) -> Costs:
    """kind: train | prefill | decode."""
    n_params = param_count(model_decls(cfg))
    n_active = _active_params(cfg)

    if kind == "train":
        tokens_new, ctx_avg, dec_tokens = batch * seq, seq / 2, batch * seq
    elif kind == "prefill":
        tokens_new, ctx_avg, dec_tokens = batch * seq, seq / 2, batch * seq
    else:  # decode: one token against a seq-length cache
        tokens_new, ctx_avg, dec_tokens = batch * 1, seq, batch * 1

    fwd = 0.0
    kv_bytes = 0.0
    for i in range(cfg.num_layers):
        bt = cfg.block_type(i)
        if bt in (ATTN, ATTN_L, ATTN_MOE, DEC_ATTN):
            w = cfg.window_for(bt)
            ctx = min(ctx_avg, w) if w else ctx_avg
            cross = cfg.encoder_seq if bt == DEC_ATTN else 0
            fwd += _attn_layer_flops(cfg, tokens_new, ctx, w, cross)
            cache_len = min(seq, w) if (w and window_cache) else seq
            kv_bytes += 2 * batch * cache_len * cfg.num_kv_heads * cfg.hd \
                * kv_dtype_bytes
        elif bt in (MAMBA, MAMBA_MOE):
            fwd += _mamba_flops(cfg, tokens_new)
            kv_bytes += batch * cfg.d_inner * cfg.mamba_d_state * F32
        elif bt == MLSTM:
            fwd += _mlstm_flops(cfg, tokens_new)
            DI = int(cfg.xlstm_proj_factor * cfg.d_model)
            hd = DI // cfg.num_heads
            kv_bytes += batch * cfg.num_heads * hd * hd * F32
        elif bt == SLSTM:
            fwd += _slstm_flops(cfg, tokens_new)
            kv_bytes += 4 * batch * cfg.d_model * F32
        if bt in MOE_BLOCKS:
            fwd += _moe_flops(cfg, tokens_new)
        elif bt not in (MLSTM, SLSTM):
            fwd += _mlp_flops(cfg, tokens_new)
    # encoder (whisper): runs once per sequence in train/prefill
    if cfg.is_encoder_decoder and kind != "decode":
        enc_t = batch * cfg.encoder_seq
        for _ in range(cfg.num_encoder_layers):
            fwd += _attn_layer_flops(cfg, enc_t, cfg.encoder_seq / 2, 0)
            fwd += _mlp_flops(cfg, enc_t)
    # lm head
    head_tokens = batch if kind == "prefill" else tokens_new  # last_only
    fwd += 2 * head_tokens * cfg.d_model * cfg.vocab_size

    params_bytes = n_params * BF16
    act_stream = tokens_new * cfg.d_model * BF16 * cfg.num_layers

    if kind == "train":
        flops = fwd * (4.0 if remat else 3.0)   # fwd + 2x bwd (+1x remat)
        # fwd reads params; bwd reads params; optimizer reads/writes p,m,v f32
        hbm = params_bytes * 2 + n_params * F32 * 6 + act_stream * 6
        model_flops = 6.0 * n_active * dec_tokens
    elif kind == "prefill":
        flops = fwd
        hbm = params_bytes + kv_bytes + act_stream * 4
        model_flops = 2.0 * n_active * dec_tokens
    else:
        flops = fwd
        # decode is bandwidth-bound: weights + full KV/state read + write
        hbm = params_bytes + kv_bytes + act_stream * 4
        model_flops = 2.0 * n_active * dec_tokens
    return Costs(flops, hbm, model_flops, kv_bytes)


# Hardware constants: NVIDIA H100 SXM5 80 GB at its 700 W power limit, per
# GPU, from NVIDIA's datasheet. A card capped below 700 W runs slower than
# these under load.
PEAK_FLOPS = 989e12       # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12          # HBM3 bytes/s
# bytes/s per GPU across nodes: one NDR 400 Gb/s InfiniBand NIC per GPU. An
# NVLink domain holds 8 GPUs, so a 16-wide model axis spans two nodes and
# its collectives are bound by this link, not by NVLink's 450 GB/s a way.
ICI_BW = 50e9


def roofline_terms(costs: Costs, coll_bytes_per_dev: float, chips: int) -> dict:
    compute_s = costs.flops / (chips * PEAK_FLOPS)
    memory_s = costs.hbm_bytes / (chips * HBM_BW)
    collective_s = coll_bytes_per_dev / ICI_BW
    dominant = max(
        [("compute", compute_s), ("memory", memory_s),
         ("collective", collective_s)], key=lambda kv: kv[1])[0]
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "useful_flops_ratio": costs.model_flops / max(costs.flops, 1.0),
    }
