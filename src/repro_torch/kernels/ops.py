"""Public attention ops of the port, dispatched on the tensor's device.

A CUDA tensor goes to the hand-written Hopper kernel, which launches or
raises: a failed build or launch is never hidden behind the plain version.
A CPU tensor goes to the plain torch version in ``ref.py`` (the tests run
there). Any other device raises.
"""
from __future__ import annotations

from . import paged_attention as _decode
from . import paged_prefill_attention as _prefill
from .ref import ref_paged_attention, ref_paged_prefill_attention

KERNELS = {"paged_attention": _decode,
           "paged_prefill_attention": _prefill}


def _route(t) -> str:
    if t.device.type in ("cuda", "cpu"):
        return t.device.type
    raise ValueError(f"no attention kernel for device {t.device}")


def paged_attention(q, k_pages, v_pages, block_table, lengths, *,
                    softcap: float = 0.0):
    if _route(q) == "cuda":
        return _decode.paged_attention(q, k_pages, v_pages, block_table,
                                       lengths, softcap=softcap)
    return ref_paged_attention(q, k_pages, v_pages, block_table, lengths,
                               softcap=softcap)


def paged_prefill_attention(q, k_pages, v_pages, block_table, q_start,
                            new_lens, *, softcap: float = 0.0):
    if _route(q) == "cuda":
        return _prefill.paged_prefill_attention(
            q, k_pages, v_pages, block_table, q_start, new_lens,
            softcap=softcap)
    return ref_paged_prefill_attention(q, k_pages, v_pages, block_table,
                                       q_start, new_lens, softcap=softcap)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last ``reset_launch_counts``."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
