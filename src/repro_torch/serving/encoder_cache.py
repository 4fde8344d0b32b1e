"""Encoder-output cache — the "pebble cache".

Vision-encoder outputs are pure functions of the mm input, and real
traffic repeats inputs (the same image re-asked with a new question,
thumbnails, shared attachments). The engine keys encoder outputs by a
content hash of the mm payload (``Request.mm_hash``): a hit skips the
ENCODING stage entirely — the request goes straight to the prefill queue
with its embeddings "already resident" — which can only improve TTFT,
never change outputs (tests/test_encode_pipeline.py property-tests both).

The sim tracks presence only; a real deployment would pin the embedding
tensors (mm_units x d_model) and account their HBM against the KV budget.
LRU eviction bounds that footprint. ``WorkloadConfig.duplicate_prob``
exercises the cache with controlled input reuse.
"""
from __future__ import annotations

from collections import OrderedDict


class EncoderCache:
    """LRU over mm-content hashes with hit/miss accounting.

    Entries can be **pinned** (ref-counted): while any in-flight request
    depends on an entry — it hit the cache at ingest, or is mid-encode and
    will insert/share it — LRU eviction must never drop it (in a real
    deployment the embeddings would vanish under the request). Pins are
    keyed by hash and may precede the insert (a request in
    ``State.ENCODING`` reserves its hash before the output lands); the
    cache may transiently exceed ``capacity`` when everything resident is
    pinned, bounded by the number of in-flight mm requests.
    """

    __slots__ = ("capacity", "hits", "misses", "insertions", "evictions",
                 "_lru", "_pins")

    def __init__(self, capacity: int = 256):
        if capacity <= 0:
            raise ValueError("EncoderCache capacity must be positive")
        self.capacity = capacity
        self.hits = 0
        self.misses = 0
        self.insertions = 0
        self.evictions = 0
        self._lru: OrderedDict[str, int] = OrderedDict()  # hash -> mm_units
        self._pins: dict[str, int] = {}                   # hash -> refcount

    def __len__(self) -> int:
        return len(self._lru)

    def __contains__(self, key: str) -> bool:
        return key in self._lru

    def lookup(self, key: str) -> bool:
        """Consult the cache for one request's mm input (counts the
        hit/miss); a hit refreshes the entry's recency."""
        if key in self._lru:
            self._lru.move_to_end(key)
            self.hits += 1
            return True
        self.misses += 1
        return False

    def insert(self, key: str, mm_units: int = 0) -> None:
        """Record a freshly-encoded input; evicts LRU beyond capacity
        (pinned entries are skipped — the cache runs over capacity rather
        than drop an entry someone is mid-flight on). Re-inserting an
        existing key only refreshes recency."""
        if key in self._lru:
            self._lru.move_to_end(key)
            return
        self._lru[key] = mm_units
        self.insertions += 1
        over = len(self._lru) - self.capacity
        if over > 0:
            for victim in [k for k in self._lru
                           if k not in self._pins][:over]:
                del self._lru[victim]
                self.evictions += 1

    # -- pinning --------------------------------------
    def pin(self, key: str) -> None:
        """Ref-count a dependency on ``key``. Valid before the insert
        (mid-encode reservation) as well as after (ingest hit)."""
        self._pins[key] = self._pins.get(key, 0) + 1

    def unpin(self, key: str) -> None:
        n = self._pins.get(key, 0) - 1
        assert n >= 0, f"unpin of never-pinned encoder-cache key {key!r}"
        if n == 0:
            del self._pins[key]
        else:
            self._pins[key] = n

    def pin_count(self, key: str) -> int:
        return self._pins.get(key, 0)

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "entries": len(self._lru),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "insertions": self.insertions,
            "evictions": self.evictions,
            "pinned": len(self._pins),
            "pin_refs": sum(self._pins.values()),
        }
