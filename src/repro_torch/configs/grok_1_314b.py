"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1].

64L, d_model=6144, 48 heads (GQA kv=8), d_ff=32768, vocab=131072,
MoE 8e top-2 on every layer; attention-logit softcap 30.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    arch_type="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    num_experts=8,
    experts_per_token=2,
    moe_every=1,
    logit_softcap=30.0,
    max_seq_len=8192,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        d_ff=512, vocab_size=512, num_experts=4, max_seq_len=512)
