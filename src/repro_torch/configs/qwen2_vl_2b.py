"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].

28L, d_model=1536, 12 heads (GQA kv=2), d_ff=8960, vocab=151936.
Vision frontend (ViT + projector) is a STUB per the brief: ``input_specs``
provides precomputed patch embeddings of shape (B, mm_tokens, d_model).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    arch_type="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    rope_style="mrope",
    rope_theta=1000000.0,
    qkv_bias=True,
    mm_tokens=1024,
    max_seq_len=32768,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        d_ff=512, vocab_size=512, mm_tokens=16, max_seq_len=512)
