"""gemma3-27b [dense] — 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt family].

62L, d_model=5376, 32 heads (GQA kv=16), d_ff=21504, vocab=262144.
head_dim=128 (model card). Sliding window 1024 on local layers; every 6th
layer is global.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    arch_type="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    rope_style="llama",
    rope_theta=1000000.0,
    sliding_window=1024,
    local_global_period=6,
    max_seq_len=1048576,
)


def reduced() -> ModelConfig:
    # pattern [attn_l, attn]: one local + one global layer
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=512, sliding_window=64,
        local_global_period=2, max_seq_len=512)
