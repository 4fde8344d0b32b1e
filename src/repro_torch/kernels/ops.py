"""Public attention ops of the port, dispatched on the tensor's device.

A CUDA tensor goes to the hand-written Hopper kernel, which launches or
raises: a failed build or launch is never hidden behind the plain version.
A CPU tensor goes to the plain torch version in ``ref.py`` (the tests run
there). Any other device raises.

No kernel has a backward, in this package or in the JAX one (``jax.grad``
fails through the Pallas kernels), and a kernel's output, written through
ctypes, carries no autograd node. So every op raises when gradients are
enabled and any tensor input requires one, on both routes, rather than
return an output the gradient would silently skip: training sends its
attention through ``layers.mha`` (``transformer.forward(...,
causal_impl="mha")``).
"""
from __future__ import annotations

import torch

from . import paged_attention as _decode
from . import paged_prefill_attention as _prefill
from . import prefill_attention as _dense
from .ref import (ref_paged_attention, ref_paged_prefill_attention,
                  ref_prefill_attention)

KERNELS = {"paged_attention": _decode,
           "paged_prefill_attention": _prefill,
           "prefill_attention": _dense}


def _refuse_autograd(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward; run it under "
            "torch.no_grad() or route training through layers.mha")


def _route(t) -> str:
    if t.device.type in ("cuda", "cpu"):
        return t.device.type
    raise ValueError(f"no attention kernel for device {t.device}")


def paged_attention(q, k_pages, v_pages, block_table, lengths, *,
                    softcap: float = 0.0):
    _refuse_autograd("paged_attention", q, k_pages, v_pages)
    if _route(q) == "cuda":
        return _decode.paged_attention(q, k_pages, v_pages, block_table,
                                       lengths, softcap=softcap)
    return ref_paged_attention(q, k_pages, v_pages, block_table, lengths,
                               softcap=softcap)


def paged_prefill_attention(q, k_pages, v_pages, block_table, q_start,
                            new_lens, *, softcap: float = 0.0):
    _refuse_autograd("paged_prefill_attention", q, k_pages, v_pages)
    if _route(q) == "cuda":
        return _prefill.paged_prefill_attention(
            q, k_pages, v_pages, block_table, q_start, new_lens,
            softcap=softcap)
    return ref_paged_prefill_attention(q, k_pages, v_pages, block_table,
                                       q_start, new_lens, softcap=softcap)


def prefill_attention(q, k, v, *, q_start: int = 0, window: int = 0,
                      softcap: float = 0.0):
    _refuse_autograd("prefill_attention", q, k, v)
    if _route(q) == "cuda":
        return _dense.prefill_attention(q, k, v, q_start=q_start,
                                        window=window, softcap=softcap)
    return ref_prefill_attention(q, k, v, q_start=q_start, window=window,
                                 softcap=softcap)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last ``reset_launch_counts``."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


def add_launch_counts(counts: dict[str, int]) -> None:
    """Add ``counts`` (by kernel name, negative to take away) to the
    launch counters: a replayed CUDA graph's launches, which run no
    Python."""
    for name, n in counts.items():
        KERNELS[name].launches += n
