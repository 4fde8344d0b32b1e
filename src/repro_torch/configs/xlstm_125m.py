"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

12L, d_model=768, 4 heads, d_ff=0 (blocks carry their own projections),
vocab=50304. sLSTM at every 6th layer (offset 3), mLSTM elsewhere.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    arch_type="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    rope_style="none",
    slstm_every=6,
    slstm_offset=3,
    xlstm_proj_factor=2.0,
    tie_embeddings=True,
    max_seq_len=1048576,
)


def reduced() -> ModelConfig:
    # pattern [mlstm, slstm]
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
        vocab_size=512, slstm_every=2, slstm_offset=1, max_seq_len=512)
