"""Unified model configuration covering all six assigned architecture families.

A config fully determines the layer *pattern* (which block type at which
depth) and the *stage* decomposition into (period, repeats) stages; each
stage's weights are stacked on a leading ``layers`` dim, which the forward
walks with a Python loop. ``dtype`` is the torch compute dtype.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

# Block type names
ATTN = "attn"            # global causal attention + dense MLP
ATTN_L = "attn_l"        # sliding-window attention + dense MLP
ATTN_MOE = "attn_moe"    # global causal attention + MoE
MAMBA = "mamba"          # mamba block + dense MLP
MAMBA_MOE = "mamba_moe"  # mamba block + MoE
MLSTM = "mlstm"          # xLSTM matrix-memory block
SLSTM = "slstm"          # xLSTM scalar-memory block
ENC_ATTN = "enc_attn"    # bidirectional encoder attention + MLP
DEC_ATTN = "dec_attn"    # causal self-attn + cross-attn + MLP

ATTN_BLOCKS = {ATTN, ATTN_L, ATTN_MOE, ENC_ATTN, DEC_ATTN}
SSM_BLOCKS = {MAMBA, MAMBA_MOE, MLSTM, SLSTM}
MOE_BLOCKS = {ATTN_MOE, MAMBA_MOE}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 0       # MoE MLP at layers i with i % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25

    # --- attention variants ---
    rope_style: str = "llama"   # llama | mrope | half | none
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    sliding_window: int = 0      # window size for ATTN_L blocks
    local_global_period: int = 0 # gemma3: (period-1) local then 1 global
    logit_softcap: float = 0.0   # grok/gemma style attn logit soft-capping

    # --- hybrid (jamba) ---
    attn_every: int = 0    # attention at layers i with i % attn_every == attn_offset
    attn_offset: int = 0
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # --- xLSTM ---
    slstm_every: int = 0   # sLSTM at layers i with i % slstm_every == slstm_offset
    slstm_offset: int = 0
    xlstm_proj_factor: float = 2.0

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 1500     # stub conv-frontend output frames
    max_target_positions: int = 448

    # --- multimodal stub ---
    mm_tokens: int = 0          # stub patch/frame embedding tokens per request

    # --- misc ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    max_seq_len: int = 131072
    dtype: Any = torch.bfloat16

    # set by pad_for_tp for the dry-run; 0 = unpadded
    orig_num_heads: int = 0
    orig_num_kv_heads: int = 0

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    def is_moe_layer(self, i: int) -> bool:
        return self.num_experts > 0 and self.moe_every > 0 and i % self.moe_every == self.moe_offset

    def block_type(self, i: int) -> str:
        """Block type for decoder layer i."""
        if self.arch_type == "ssm" and self.slstm_every >= 0 and self.d_ff == 0:
            if self.slstm_every > 0 and i % self.slstm_every == self.slstm_offset:
                return SLSTM
            return MLSTM
        if self.attn_every > 0:  # hybrid: attention only at some layers
            is_attn = i % self.attn_every == self.attn_offset
            moe = self.is_moe_layer(i)
            if is_attn:
                return ATTN_MOE if moe else ATTN
            return MAMBA_MOE if moe else MAMBA
        if self.is_encoder_decoder:
            return DEC_ATTN
        moe = self.is_moe_layer(i)
        if moe:
            return ATTN_MOE
        if self.local_global_period > 0:
            return ATTN if (i + 1) % self.local_global_period == 0 else ATTN_L
        if self.sliding_window > 0 and self.local_global_period == 0:
            return ATTN_L
        return ATTN

    def pattern(self) -> tuple[str, ...]:
        return tuple(self.block_type(i) for i in range(self.num_layers))

    def encoder_pattern(self) -> tuple[str, ...]:
        return tuple(ENC_ATTN for _ in range(self.num_encoder_layers))

    def stages(self) -> list[tuple[tuple[str, ...], int]]:
        """Decompose the decoder pattern into (period, repeats) stages."""
        return decompose_stages(self.pattern())

    def is_global_attn(self, block: str) -> bool:
        return block in (ATTN, ATTN_MOE, DEC_ATTN, ENC_ATTN)

    def window_for(self, block: str) -> int:
        return self.sliding_window if block == ATTN_L else 0

    def has_cross_attn(self, block: str) -> bool:
        return block == DEC_ATTN

    def norm_style(self) -> str:
        return "layernorm" if self.is_encoder_decoder else "rmsnorm"


def decompose_stages(pattern: tuple[str, ...]) -> list[tuple[tuple[str, ...], int]]:
    """Find the smallest period p such that pattern tiles by p, with remainder.

    Returns stages [(period_blocks, repeats), (remainder_blocks, 1)?].
    """
    n = len(pattern)
    if n == 0:
        return []
    for p in range(1, n + 1):
        reps = n // p
        if reps >= 1 and pattern[: p * reps] == pattern[:p] * reps:
            rem = pattern[p * reps:]
            # require the periodic part to actually cover the prefix
            if all(pattern[i] == pattern[i % p] for i in range(p * reps)):
                stages = [(pattern[:p], reps)]
                if rem:
                    stages.append((rem, 1))
                return stages
    return [(pattern, 1)]


def pad_for_tp(cfg: ModelConfig, tp: int) -> ModelConfig:
    """Pad query heads / replicate KV heads to a multiple of the TP degree.

    Standard practice (vLLM/MaxText require divisibility); the inflation is
    accounted in the roofline useful-FLOPs ratio.
    """
    def up(x: int) -> int:
        return ((x + tp - 1) // tp) * tp

    nh, nkv, nv = cfg.num_heads, cfg.num_kv_heads, cfg.vocab_size
    new_h, new_kv, new_v = up(nh), up(nkv), up(nv)
    if (new_h, new_kv, new_v) == (nh, nkv, nv):
        return cfg
    return dataclasses.replace(
        cfg,
        num_heads=new_h,
        num_kv_heads=new_kv,
        vocab_size=new_v,  # MaxText-style vocab padding for TP lm_head
        head_dim=cfg.hd,   # freeze head_dim so padding doesn't change it
        orig_num_heads=nh,
        orig_num_kv_heads=nkv,
    )
