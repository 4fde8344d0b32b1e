"""qwen1.5-110b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B family].

80L, d_model=8192, 64 heads (GQA kv=8), d_ff=49152, vocab=152064.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    arch_type="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    rope_style="llama",
    rope_theta=1000000.0,
    qkv_bias=True,
    max_seq_len=32768,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        d_ff=512, vocab_size=512, max_seq_len=512)
