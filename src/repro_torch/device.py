"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on. Entry points default to
    ``"cuda"``; with no CUDA device this raises rather than falling back,
    so a CPU run is always one the caller asked for (``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def synchronize(device) -> None:
    """Wait for queued device work, so a host clock read after it times
    the work and not just its launch."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
