"""chatglm3-6b [dense] — RoPE over half the head dim ("2d"), GQA
[arXiv:2406.12793].

28L, d_model=4096, 32 heads (GQA kv=2), d_ff=13696, vocab=65024.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    arch_type="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope_style="half",
    qkv_bias=True,
    max_seq_len=32768,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        d_ff=512, vocab_size=512, max_seq_len=512)
