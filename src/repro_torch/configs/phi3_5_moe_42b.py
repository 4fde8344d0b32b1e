"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct].

32L, d_model=4096, 32 heads (GQA kv=8), d_ff=6400, vocab=32064.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    num_experts=16,
    experts_per_token=2,
    moe_every=1,
    max_seq_len=131072,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        d_ff=512, vocab_size=512, num_experts=4, max_seq_len=512)
