"""Rotary position embedding variants.

llama  — standard RoPE over the full head dim (deepseek, gemma, qwen, grok...)
half   — rotary over the first half of the head dim (ChatGLM3 "2d" RoPE)
mrope  — multimodal 3-section RoPE (temporal/height/width) from Qwen2-VL
none   — no rotary (whisper uses learned absolute positions)
"""
from __future__ import annotations

import torch

from .sharding import replicate


def _rotate_half(x):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _angles(positions, dim: int, theta: float):
    """positions (..., S) -> cos/sin (..., S, dim//2)."""
    inv_freq = replicate(1.0 / (theta ** (torch.arange(
        0, dim, 2, dtype=torch.float32, device=positions.device) / dim)))
    ang = positions[..., None].to(torch.float32) * inv_freq
    return torch.cos(ang), torch.sin(ang)


def rope_tables(positions, D: int, theta: float = 10000.0,
                style: str = "llama", mrope_sections=(2, 3, 3)):
    """cos/sin tables for ``apply_rope_tables``: positions (B, S), or
    (B, S, 3) for mrope, -> (cos, sin) each (B, S, 1, rot) f32, where rot is
    the rotated width (D, or D//2 for ``half``). None for ``none``. The
    forward computes them once and reuses them in every layer."""
    if style == "none":
        return None
    if style == "llama":
        cos, sin = _angles(positions, D, theta)
    elif style == "half":
        # rotary on the first half of the head dim only (ChatGLM)
        cos, sin = _angles(positions, D // 2, theta)
    elif style == "mrope":
        # positions (B,S,3): temporal, height, width streams; each section of
        # the frequency spectrum takes its angles from one stream. 2-D
        # positions broadcast to all three streams.
        if positions.ndim == 2:
            positions = positions[..., None].expand(*positions.shape, 3)
        half = D // 2
        total = sum(mrope_sections)
        sizes = [half * s // total for s in mrope_sections]
        sizes[-1] = half - sum(sizes[:-1])
        cos_full, sin_full = _angles(
            torch.movedim(positions, -1, 0), D, theta)  # (3, B, S, half)
        parts_c, parts_s = [], []
        off = 0
        for sec, sz in enumerate(sizes):
            parts_c.append(cos_full[sec, ..., off:off + sz])
            parts_s.append(sin_full[sec, ..., off:off + sz])
            off += sz
        cos = torch.cat(parts_c, dim=-1)
        sin = torch.cat(parts_s, dim=-1)
    else:
        raise ValueError(f"unknown rope style {style!r}")
    return (torch.cat([cos, cos], dim=-1)[:, :, None, :],
            torch.cat([sin, sin], dim=-1)[:, :, None, :])


def apply_rope_tables(x, tables):
    """Rotate x (B, S, H, D) with ``rope_tables`` output; a table narrower
    than D (``half``) rotates the leading dims and passes the rest."""
    if tables is None:
        return x
    cos, sin = tables
    rot = cos.shape[-1]
    xr = x[..., :rot].to(torch.float32)
    out = (xr * cos + _rotate_half(xr) * sin).to(x.dtype)
    if rot == x.shape[-1]:
        return out
    return torch.cat([out, x[..., rot:]], dim=-1)


def apply_rope(x, positions, theta: float = 10000.0, style: str = "llama",
               mrope_sections=(2, 3, 3)):
    """Apply rotary embedding.

    x: (B, S, H, D). positions: (B, S) int, or (B, S, 3) for mrope.
    mrope_sections: relative weights of the t/h/w sections (scaled to D//2).
    """
    return apply_rope_tables(
        x, rope_tables(positions, x.shape[-1], theta, style, mrope_sections))
