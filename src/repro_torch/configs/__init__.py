"""Assigned-architecture registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``.

Each module defines ``CONFIG`` (the exact assigned configuration, with the
source citation) and ``reduced()`` (a smoke-test variant of the same family:
<=2-ish layers covering one full block period, d_model<=512, <=4 experts).
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "deepseek_coder_33b",
    "qwen2_vl_2b",
    "jamba_1_5_large_398b",
    "grok_1_314b",
    "phi3_5_moe_42b",
    "gemma3_27b",
    "chatglm3_6b",
    "xlstm_125m",
    "qwen1_5_110b",
    "whisper_base",
]

# CLI aliases (assignment spelling -> module)
ALIASES = {
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "grok-1-314b": "grok_1_314b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "gemma3-27b": "gemma3_27b",
    "chatglm3-6b": "chatglm3_6b",
    "xlstm-125m": "xlstm_125m",
    "qwen1.5-110b": "qwen1_5_110b",
    "whisper-base": "whisper_base",
}


def _module(arch: str):
    name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_reduced(arch: str):
    return _module(arch).reduced()
