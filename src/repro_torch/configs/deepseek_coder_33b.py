"""deepseek-coder-33b [dense] — llama-arch [arXiv:2401.14196].

62L, d_model=7168, 56 heads (GQA kv=8), d_ff=19200, vocab=32256.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    arch_type="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    rope_style="llama",
    rope_theta=100000.0,
    max_seq_len=32768,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        d_ff=512, vocab_size=512, max_seq_len=512)
