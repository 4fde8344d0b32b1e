"""Engine-side KV memory subsystem: page accounting (allocator) and the
torch paged store (paged — imported directly to avoid pulling torch into
scheduler-only code paths)."""
from .allocator import (BlockAllocator, OutOfPages, PrefixMatch,
                        common_prefix_tokens, iter_page_runs)

__all__ = ["BlockAllocator", "OutOfPages", "PrefixMatch",
           "common_prefix_tokens", "iter_page_runs"]
