"""Page allocator with a ref-counted KV prefix cache.

This is the engine-side memory accounting for the KV cache (the substrate
the paper's memory-pressure experiments, §2.4/§4.3.2, exercise): capacity
is expressed in fixed-size pages; requests allocate pages as their context
grows and release them on completion/preemption. The scheduler consults
``can_allocate``/``utilization`` for admission and preemption decisions.

On top of the free-list substrate sits a **prefix cache** (
DESIGN.md §KV prefix cache): completed prefills publish their page chains
into a trie keyed by page-aligned *content runs*, so any later request
whose prompt shares a page-aligned prefix (same system prompt, same mm
payload — not just whole-prompt duplicates) re-uses the cached KV pages
instead of re-prefilling them:

  * every page carries a **reference count** = number of requests whose
    block tables include it; freeing a request only returns pages whose
    count drops to zero — shared pages survive any one owner's preemption
    or completion;
  * zero-ref pages that are still indexed stay **cached**: they hold
    reusable KV, count as free for admission (``available_pages``), and
    are evicted LRU, subtree-at-a-time, only when an allocation actually
    needs them;
  * the first *partially*-shared page is claimed **copy-on-write**: the
    donor's boundary page is copied into a fresh private page and the
    request resumes prefilling mid-page instead of at the page boundary.

All content identity is structural — chunks of ``(content_id, tokens)``
(see ``Request.content_chunks``) are re-cut into per-page run tuples, so
two prompts match exactly where their content matches. Private content ids
(containing ``"!"``) can never recur across requests, so chains never
extend past a private-led page and pure-text prompts without a shared
system prefix are skipped outright (no index growth, no match scans).
Content-addressed mm payloads *are* published even before any duplicate
exists — a later duplicate must find the chain — so mm-heavy workloads
grow an index bounded by KV capacity (zero-ref chains are the first thing
eviction reclaims under pressure); match lookups stay O(pages) via the
exact-key child dict plus first-run head buckets for the COW scan.

All operations are O(pages moved). ``check_invariants`` asserts refcount
conservation, free/owned/cached partitioning, and trie well-formedness.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field


class OutOfPages(Exception):
    pass


def iter_page_runs(chunks, page_size: int):
    """Re-cut content chunks ``[(content_id, tokens), ...]`` into pages.

    Yields ``(runs, tokens)`` per page in prompt order: ``runs`` is a
    tuple of ``(content_id, start_offset, length)`` segments covering the
    page and ``tokens`` its token count (== page_size except the final
    partial page). Two prompts produce equal run tuples for a page exactly
    when that page's token content is identical — the trie key.
    """
    runs: list = []
    filled = 0
    for cid, n in chunks:
        off = 0
        while off < n:
            take = min(n - off, page_size - filled)
            runs.append((cid, off, take))
            off += take
            filled += take
            if filled == page_size:
                yield tuple(runs), page_size
                runs, filled = [], 0
    if filled:
        yield tuple(runs), filled


def common_prefix_tokens(a, b) -> int:
    """Longest common leading token span of two page-run tuples."""
    common = 0
    for (c1, o1, l1), (c2, o2, l2) in zip(a, b):
        if c1 != c2 or o1 != o2:
            break
        common += min(l1, l2)
        if l1 != l2:
            break
    return common


def _shareable(cid: str) -> bool:
    """Private content ids (``"!"``) never recur across requests, so a
    page is only worth indexing while its *leading* run is shareable."""
    return "!" not in cid


@dataclass
class PrefixMatch:
    """Longest cached page-aligned prefix for one prompt (pure query)."""
    pages: list            # fully-shared pages, chain order
    tokens: int            # claimable tokens incl. the COW tail
    cow_src: int | None = None   # donor page for the partially-shared page
    cow_valid: int = 0           # leading tokens of cow_src valid here


class _Node:
    """One cached page in the prefix trie (the path is the chain hash)."""
    __slots__ = ("page", "runs", "parent", "children", "heads", "tick")

    def __init__(self, page, runs, parent):
        self.page = page
        self.runs = runs          # this node's key in parent.children
        self.parent = parent
        self.children: dict = {}  # runs tuple -> _Node
        # COW-candidate buckets: first-run (cid, offset) -> [children].
        # A partial match needs an identical first run, so the donor scan
        # only ever touches one bucket instead of every child (a busy
        # root can hold hundreds of unrelated chains).
        self.heads: dict = {}
        self.tick = 0             # LRU recency stamp

    def link(self, child: "_Node") -> None:
        self.children[child.runs] = child
        self.heads.setdefault(child.runs[0][:2], []).append(child)

    def unlink(self, child: "_Node") -> None:
        del self.children[child.runs]
        key = child.runs[0][:2]
        bucket = self.heads[key]
        bucket.remove(child)
        if not bucket:
            del self.heads[key]


@dataclass
class BlockAllocator:
    num_pages: int
    page_size: int
    _free: list[int] = field(default_factory=list)
    _owned: dict[str, list[int]] = field(default_factory=dict)

    def __post_init__(self):
        self._free = list(range(self.num_pages - 1, -1, -1))
        self._ref: dict[int, int] = {}        # page -> live owners
        self._root = _Node(None, (), None)
        self._node_of: dict[int, _Node] = {}  # cached page -> trie node
        self._cached_free: set[int] = set()   # cached AND zero-ref
        self._lru_heap: list[tuple[int, int]] = []  # (tick, page), lazy
        self._tick = 0
        # prefix-cache stats (surfaced via prefix_stats())
        self.prefix_hits = 0
        self.prefix_tokens_served = 0
        self.prefix_evictions = 0
        self.cow_copies = 0
        self.published_pages = 0
        self.imported_pages = 0   # pages installed via import_chain

    # -- queries ----------------------------------------------------------
    @property
    def free_pages(self) -> int:
        """Pages on the raw free list (excludes evictable cached pages)."""
        return len(self._free)

    @property
    def evictable_pages(self) -> int:
        """Cached zero-ref pages: reusable KV, reclaimable on demand."""
        return len(self._cached_free)

    @property
    def available_pages(self) -> int:
        """What an allocation can actually draw on: free + evictable."""
        return len(self._free) + len(self._cached_free)

    @property
    def cached_pages(self) -> int:
        return len(self._node_of)

    @property
    def used_pages(self) -> int:
        return self.num_pages - self.available_pages

    def utilization(self) -> float:
        return self.used_pages / max(self.num_pages, 1)

    def pages_for_tokens(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def can_allocate(self, tokens: int, rid: str | None = None,
                     match: PrefixMatch | None = None) -> bool:
        """Would ``allocate`` (after an optional prefix claim) succeed?

        ``rid``: count the pages the request already owns, mirroring
        ``allocate``'s incremental ``need`` (a growth check for a request
        holding pages must not demand room for its whole context again).
        ``match``: shared pages come from the cache rather than the free
        list, but zero-ref matched pages (and the COW donor) stop being
        evictable the moment they are claimed, so they leave ``available``.
        """
        need = self.pages_for_tokens(tokens)
        if rid is not None:
            need -= len(self._owned.get(rid, ()))
        avail = len(self._free) + len(self._cached_free)
        if match is not None and match.tokens > 0:
            need -= len(match.pages)
            avail -= sum(1 for p in match.pages
                         if self._ref.get(p, 0) == 0)
            if match.cow_src is not None and \
                    self._ref.get(match.cow_src, 0) == 0:
                avail -= 1   # pinned while its copy is allocated
        return need <= avail

    def pages_of(self, rid: str) -> list[int]:
        return list(self._owned.get(rid, ()))

    def owned_pages(self, rid: str) -> int:
        return len(self._owned.get(rid, ()))

    def ref_count(self, page: int) -> int:
        return self._ref.get(page, 0)

    def owned_map(self) -> dict[str, tuple[int, ...]]:
        """Live ownership snapshot: rid -> page tuple in block-table
        order — what the lifecycle-journal replay oracle must reproduce
        bit-exactly (serving/journal.py)."""
        return {rid: tuple(ps) for rid, ps in self._owned.items() if ps}

    def export_hot_chains(self, max_pages: int) -> list[list]:
        """Hottest cached chains, for warming a restarted peer's trie:
        one greedy path per root chain — root children hottest-first,
        then the hottest child at every node — capped at ``max_pages``
        pages total. Entries are ``(runs, tokens, page)`` in chain
        order: the first two fields are the manifest shape
        ``import_chain`` consumes (every trie node is a full page), the
        third is where this allocator holds the payload."""
        out: list[list] = []
        budget = max_pages
        for root in sorted(self._root.children.values(),
                           key=lambda n: -n.tick):
            if budget <= 0:
                break
            chain, node = [], root
            while node is not None and budget > 0:
                chain.append((node.runs, self.page_size, node.page))
                budget -= 1
                node = max(node.children.values(),
                           key=lambda c: c.tick, default=None)
            if chain:
                out.append(chain)
        return out

    # -- prefix cache: match / claim / publish ----------------------------
    def match_prefix(self, chunks, limit_tokens: int) -> PrefixMatch:
        """Longest cached prefix of a prompt, capped at ``limit_tokens``
        (callers pass ``prompt_tokens - 1``: the last prompt token must
        always run through the model to produce the first output logits).

        Pure query — claims nothing; the result stays valid until the
        next ``allocate``/``claim_prefix`` (eviction only runs there).
        """
        pages: list[int] = []
        claimed = 0
        cow_src, cow_valid = None, 0
        if limit_tokens <= 0 or not chunks or not self._root.children \
                or not _shareable(chunks[0][0]):
            return PrefixMatch(pages, 0)   # empty index / private-led
        node = self._root
        for runs, ptoks in iter_page_runs(chunks, self.page_size):
            child = node.children.get(runs) if ptoks == self.page_size \
                else None
            if child is not None and claimed + self.page_size <= \
                    limit_tokens:
                node = child
                pages.append(child.page)
                claimed += self.page_size
                continue
            # first page that cannot be fully shared: the best partially-
            # matching cached sibling becomes the copy-on-write donor (a
            # partial match requires an identical first run, so only that
            # head bucket is scanned)
            best = 0
            if _shareable(runs[0][0]):
                for cand in node.heads.get(runs[0][:2], ()):
                    c = common_prefix_tokens(runs, cand.runs)
                    if c > best:
                        best, cow_src = c, cand.page
            cow_valid = min(best, limit_tokens - claimed, ptoks)
            if cow_valid <= 0:
                cow_src, cow_valid = None, 0
            break
        return PrefixMatch(pages, claimed + cow_valid, cow_src, cow_valid)

    def claim_prefix(self, rid: str,
                     match: PrefixMatch | None) -> tuple[int, int | None]:
        """Take ownership of a match for ``rid``: shared pages are
        ref-bumped in chain order (they become rows 0..k-1 of the
        request's block table); a COW donor gets a fresh private page
        allocated for its copy. Returns ``(claimed_tokens, cow_dst)``.

        Must run before any fresh allocation for ``rid`` (the page list
        is positional) and after a successful ``can_allocate(...,
        match=match)`` check.
        """
        if match is None or match.tokens <= 0:
            return 0, None
        owned = self._owned.setdefault(rid, [])
        assert not owned, f"{rid}: claim_prefix before fresh allocation"
        for p in match.pages:
            node = self._node_of[p]
            self._ref[p] = self._ref.get(p, 0) + 1
            if self._ref[p] == 1:
                self._cached_free.discard(p)
            self._touch(node)
            owned.append(p)
        cow_dst = None
        if match.cow_src is not None and match.cow_valid > 0:
            src = match.cow_src
            self._touch(self._node_of[src])
            # pin the donor while the copy's page is drawn (eviction for
            # that page must not reclaim — or hand back — the donor)
            pinned = self._ref.get(src, 0) == 0
            if pinned:
                self._cached_free.discard(src)
            cow_dst = self._pop_page()
            if pinned:
                self._cached_free.add(src)
            self._ref[cow_dst] = 1
            owned.append(cow_dst)
            self.cow_copies += 1
        self.prefix_hits += 1
        self.prefix_tokens_served += match.tokens
        return match.tokens, cow_dst

    def publish_prefix(self, rid: str, chunks,
                       max_tokens: int | None = None) -> int:
        """Index ``rid``'s prompt pages as a reusable chain (engine calls
        this when a prefill completes — the prompt KV is final and decode
        only ever writes *past* the prompt, so published pages are
        immutable). Chain pages must be fully shareable; the first
        full page mixing a shareable head with private tail content is
        published once as a COW donor, then the walk stops. An optional
        ``max_tokens`` truncates the chain the same way (the engine
        passes the popularity-gated prefix length, so content nobody
        else has asked for never bloats the index): the page containing
        token ``max_tokens`` is published once as a donor, then the walk
        stops. Re-publishing (same rid after preemption/re-admission) is
        a no-op; when another request published identical content first,
        the existing node wins and this rid's duplicate page stays
        private.
        """
        owned = self._owned.get(rid)
        if not owned or (max_tokens is not None and max_tokens <= 0):
            return 0
        node = self._root
        new = 0
        for i, (runs, ptoks) in enumerate(
                iter_page_runs(chunks, self.page_size)):
            if ptoks < self.page_size or i >= len(owned):
                break           # partial/unallocated tail: never indexed
            if not _shareable(runs[0][0]):
                break           # private-led page: unmatchable, stop
            if max_tokens is not None and i * self.page_size >= \
                    max_tokens:
                break           # wholly past the gated prefix
            child = node.children.get(runs)
            if child is not None:
                if child.page != owned[i]:
                    break       # same content cached first by another rid
            else:
                page = owned[i]
                if page in self._node_of:
                    break       # defensive: one chain per page
                child = _Node(page, runs, node)
                node.link(child)
                self._node_of[page] = child
                new += 1
            self._touch(child)
            node = child
            if any(not _shareable(cid) for cid, _o, _l in runs):
                break   # mixed boundary page: COW donor only, chain ends
            if max_tokens is not None and (i + 1) * self.page_size > \
                    max_tokens:
                break   # gated-prefix boundary page: donor, chain ends
        self.published_pages += new
        return new

    def import_chain(self, page_runs) -> list[tuple[int, int, bool]]:
        """Install a migrated page chain as *cached* trie content — the
        receive half of the page-chain transfer protocol. The
        prefix trie doubles as the transfer manifest: ``page_runs`` is a
        list of ``(runs, tokens)`` in chain order (the sender's trie
        path, already checksum-verified by the caller), and pages landing
        here are indexed zero-ref/evictable exactly as if a local prefill
        had published them — the migrated request then re-claims them
        through the ordinary ``match_prefix``/``claim_prefix`` admission
        flow, and dedup is free: positions whose content this allocator
        already caches are skipped, not re-allocated.

        Returns ``[(chain_index, page, fresh)]`` — ``fresh`` pages need
        their KV payload written (real executors scatter the transferred
        bytes in); pre-existing pages already hold identical-content KV.
        The walk stops early at a partial/private-led page (never
        shareable), when capacity is exhausted, or if eviction under
        pressure reclaimed the chain built so far — a shorter chain is
        still correct, the target just re-prefills a longer residual."""
        node = self._root
        out: list[tuple[int, int, bool]] = []
        for i, (runs, ptoks) in enumerate(page_runs):
            if ptoks < self.page_size or not _shareable(runs[0][0]):
                break
            child = node.children.get(runs)
            if child is None:
                if not self._free and not self._cached_free:
                    break   # no room for the rest of the chain
                page = self._pop_page()
                if node is not self._root and \
                        node.page not in self._node_of:
                    # the eviction inside _pop_page reclaimed our own
                    # freshly-imported chain (everything else was hotter):
                    # stop — linking to an unlinked node would corrupt
                    # the trie. Return the drawn page first.
                    self._free.append(page)
                    break
                child = _Node(page, runs, node)
                node.link(child)
                self._node_of[page] = child
                self._ref[page] = 0
                self._cached_free.add(page)
                self.imported_pages += 1
                out.append((i, page, True))
            else:
                out.append((i, child.page, False))
            self._touch(child)
            node = child
            if any(not _shareable(cid) for cid, _o, _l in runs):
                break   # mixed boundary page: COW donor only, chain ends
        return out

    def prefix_stats(self) -> dict:
        return {
            "hits": self.prefix_hits,
            "tokens_served": self.prefix_tokens_served,
            "published_pages": self.published_pages,
            "imported_pages": self.imported_pages,
            "evictions": self.prefix_evictions,
            "cow_copies": self.cow_copies,
            "cached_pages": len(self._node_of),
            "evictable_pages": len(self._cached_free),
        }

    # -- mutation ----------------------------------------------------------
    def allocate(self, rid: str, tokens: int) -> list[int]:
        """Ensure `rid` owns enough pages for `tokens` total tokens,
        evicting cold cached pages on demand."""
        have = len(self._owned.get(rid, ()))
        need = self.pages_for_tokens(tokens) - have
        if need <= 0:
            return []
        if need > len(self._free) + len(self._cached_free):
            raise OutOfPages(
                f"{rid}: need {need} pages, {len(self._free)} free + "
                f"{len(self._cached_free)} evictable")
        pages = [self._pop_page() for _ in range(need)]
        for p in pages:
            self._ref[p] = 1
        self._owned.setdefault(rid, []).extend(pages)
        return pages

    def free(self, rid: str) -> int:
        """Release ``rid``'s ownership. Shared pages survive while any
        other owner remains; zero-ref pages return to the free list —
        unless they are indexed, in which case they stay cached
        (evictable) so their KV remains reusable."""
        pages = self._owned.pop(rid, [])
        for p in pages:
            n = self._ref.get(p, 0) - 1
            if n > 0:
                self._ref[p] = n
                continue
            node = self._node_of.get(p)
            if node is not None:
                self._ref[p] = 0
                self._cached_free.add(p)
                self._touch(node)
            else:
                self._ref.pop(p, None)
                self._free.append(p)
        return len(pages)

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.tick = self._tick
        if node.page in self._cached_free:
            heapq.heappush(self._lru_heap, (self._tick, node.page))

    def _pop_page(self) -> int:
        if not self._free:
            self._evict_lru()
        return self._free.pop()

    def _evict_lru(self) -> None:
        """Reclaim the least-recently-touched evictable chain. Evicting a
        node drops its whole subtree: descendants of a zero-ref node are
        zero-ref too (any owner of a page owns its entire prefix chain),
        so the cascade only ever frees cold pages."""
        while self._lru_heap:
            tick, page = heapq.heappop(self._lru_heap)
            node = self._node_of.get(page)
            if node is None or page not in self._cached_free or \
                    node.tick != tick:
                continue   # stale heap entry (re-touched or already gone)
            self._evict_subtree(node)
            return
        raise OutOfPages("eviction requested with no evictable pages")

    def _evict_subtree(self, node: _Node) -> None:
        # iterative post-order: a single video's chain can run thousands
        # of pages deep, far past Python's recursion limit
        stack, order = [node], []
        while stack:
            n = stack.pop()
            order.append(n)
            stack.extend(n.children.values())
        for n in reversed(order):        # children before parents
            assert self._ref.get(n.page, 0) == 0, \
                "evicting a referenced page"
            n.parent.unlink(n)
            del self._node_of[n.page]
            self._cached_free.discard(n.page)
            self._ref.pop(n.page, None)
            self._free.append(n.page)
            self.prefix_evictions += 1

    def check_invariants(self) -> None:
        owned_all: dict[int, int] = {}
        for rid, ps in self._owned.items():
            assert len(set(ps)) == len(ps), f"{rid}: duplicate page"
            for p in ps:
                owned_all[p] = owned_all.get(p, 0) + 1
        # refcount conservation: every page's count == number of owners
        for p, n in owned_all.items():
            assert self._ref.get(p) == n, \
                f"page {p}: ref {self._ref.get(p)} != owners {n}"
        for p, n in self._ref.items():
            assert n == owned_all.get(p, 0), \
                f"page {p}: ref {n} but {owned_all.get(p, 0)} owners"
        free = set(self._free)
        assert len(free) == len(self._free), "double-freed page"
        assert free.isdisjoint(owned_all), "page both owned and free"
        assert free.isdisjoint(self._node_of), "page both cached and free"
        # cached zero-ref pages are exactly the evictable set
        zero_cached = {p for p in self._node_of
                       if self._ref.get(p, 0) == 0}
        assert zero_cached == self._cached_free, \
            "evictable set out of sync with zero-ref cached pages"
        assert len(free) + len(owned_all) + len(self._cached_free) == \
            self.num_pages, "page leak"
        # trie well-formedness + sharing monotonicity: every owner of a
        # page owns its whole prefix, so parent refs dominate child refs
        stack = [self._root]
        seen_pages = set()
        while stack:
            node = stack.pop()
            in_buckets = [c for b in node.heads.values() for c in b]
            assert sorted(id(c) for c in in_buckets) == \
                sorted(id(c) for c in node.children.values()), \
                "head buckets out of sync with children"
            for key, child in node.children.items():
                assert child.parent is node and child.runs == key
                assert child in node.heads.get(key[0][:2], ()), \
                    "child missing from its head bucket"
                assert child.page not in seen_pages, "page in two chains"
                seen_pages.add(child.page)
                if node is not self._root:
                    assert self._ref.get(node.page, 0) >= \
                        self._ref.get(child.page, 0), \
                        "child page more referenced than its prefix"
                stack.append(child)
        assert seen_pages == set(self._node_of), \
            "trie nodes out of sync with the page index"
