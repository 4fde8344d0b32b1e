"""whisper-base [audio] — encoder-decoder, conv frontend stubbed
[arXiv:2212.04356].

6L decoder (+6L encoder), d_model=512, 8 heads, d_ff=2048, vocab=51865.
Mel-spectrogram + conv feature extractor is a STUB per the brief:
``input_specs`` provides precomputed frame embeddings (B, 1500, 512).
Positions are sinusoidal (adaptation note in DESIGN.md: whisper's learned
decoder table is replaced so the assigned 32k decode shape is representable).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    arch_type="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    rope_style="none",
    is_encoder_decoder=True,
    num_encoder_layers=6,
    encoder_seq=1500,
    max_target_positions=448,
    max_seq_len=32768,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, num_encoder_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, d_ff=256, vocab_size=512, encoder_seq=32,
        max_seq_len=128)
