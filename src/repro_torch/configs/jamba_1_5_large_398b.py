"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887].

72L, d_model=8192, 64 heads (GQA kv=8), d_ff=24576, vocab=65536,
MoE 16 experts top-2 (every other layer). Attention at 1 of every 8 layers.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    num_experts=16,
    experts_per_token=2,
    moe_every=2,
    moe_offset=1,
    attn_every=8,
    attn_offset=4,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    max_seq_len=1048576,
)


def reduced() -> ModelConfig:
    # one mamba_moe + one attn layer: pattern [mamba_moe, attn]
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        d_ff=512, vocab_size=512, num_experts=4, moe_every=2, moe_offset=0,
        attn_every=2, attn_offset=1, max_seq_len=512)
