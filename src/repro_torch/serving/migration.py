"""Page-chain migration between replicas.

When the fleet drains a replica (rolling restart, scale-down) or rebalances
after an elastic repartition, in-flight requests move to another replica.
Without migration every move pays a full re-prefill on the target — for a
truck (video) request that is seconds of recomputation the source already
did. This module transfers the request's *prefilled KV page chain* instead,
so the target re-prefills only the residual.

The protocol leans on the prefix-cache substrate (cache/allocator.py):

  * **manifest = trie path.** Each prefilled full page is described by its
    page-run tuple — the same ``(content_id, offset, length)`` key the
    prefix trie hashes — so the target can install the chain with
    ``BlockAllocator.import_chain`` and the migrated request re-claims it
    through the ordinary ``match_prefix``/``claim_prefix`` admission flow.
    Dedup is free: chain positions the target already caches are skipped.
  * **per-page checksums.** Every ``PageRecord`` carries a CRC over its
    identity (chain index + runs) and its KV payload bytes; the receiver
    recomputes and rejects mismatches, so a corrupted chunk can never be
    installed as valid KV.
  * **bounded chunks, timeout, retry-with-backoff.** The chain ships in
    chunks of ``chunk_pages`` records. A chunk that times out or fails
    verification is retried with exponential backoff up to ``max_retries``;
    exhaustion stops the transfer at the last verified chunk.
  * **graceful degradation.** Any truncation — fault exhaustion, source
    dying mid-transfer, target capacity — yields a shorter verified prefix;
    the request simply re-prefills a longer residual on the target.
    Correctness is never at stake, only latency. Only a *target* death
    aborts the import entirely (the fleet re-dispatches elsewhere).

Timing is simulated on the stepped co-sim clock: the transfer spans
``[start, finish_time]`` and the migrated request's ``ready_floor`` holds
it un-schedulable on the target until the chain has "landed". Faults come
from ``FaultPlan.migration_fault`` — deterministic per (seed, rid, chunk),
so every chaos schedule replays bit-identically. In real-executor mode the
payload bytes genuinely move (``export_page_payload`` on the source,
``import_page_payload`` on the target); KV values are bf16-rounded on
write, so the bytes round-trip exactly and a migrated request decodes the
same tokens it would have decoded without the move.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field

from ..cache.allocator import _shareable, iter_page_runs
from .request import Request


@dataclass(frozen=True)
class MigrationConfig:
    """Transfer-protocol knobs (times in simulated seconds)."""
    chunk_pages: int = 8              # records per bounded chunk
    bandwidth_pages_per_s: float = 2000.0   # sustained inter-replica rate
    chunk_latency_s: float = 0.002    # fixed per-chunk RPC overhead
    chunk_timeout_s: float = 0.25     # deadline per chunk attempt
    max_retries: int = 3              # attempts per chunk past the first
    retry_backoff_s: float = 0.05     # base backoff, doubles per retry


@dataclass
class PageRecord:
    """One manifest entry: a prefilled page's identity + (optionally) its
    KV bytes. ``runs`` is the page's trie key; ``payload`` is None in
    sim-executor mode, where KV content is implicit."""
    index: int                 # position in the chain (0-based)
    runs: tuple                # page-run tuple (the trie/transfer key)
    tokens: int                # token count (== page_size for full pages)
    payload: bytes | None = None
    checksum: int = 0

    def seal(self) -> "PageRecord":
        self.checksum = record_checksum(self)
        return self


def record_checksum(rec: PageRecord) -> int:
    """CRC over the record's identity and payload — what the receiver
    recomputes on arrival."""
    c = zlib.crc32(repr((rec.index, rec.runs, rec.tokens)).encode())
    if rec.payload is not None:
        c = zlib.crc32(rec.payload, c)
    return c & 0xFFFFFFFF


@dataclass
class MigrationResult:
    """Outcome of one attempted page-chain transfer."""
    status: str                # migrated | fallback | aborted_source_dead
    #                            | aborted_target_dead
    delivered: list = field(default_factory=list)  # verified PageRecords
    finish_time: float = 0.0   # sim time the last verified chunk landed
    retries: int = 0           # chunk re-attempts (timeouts + corruptions)
    chunks_sent: int = 0
    pages_imported: int = 0    # fresh pages installed on the target
    pages_deduped: int = 0     # chain positions the target already cached


def build_manifest(engine, req: Request) -> list[PageRecord]:
    """Snapshot ``req``'s transferable chain on its source engine — MUST
    run before ``export_request`` frees the source pages.

    Transferable = fully-prefilled *full* pages whose leading run is
    shareable, stopping after the first page that mixes in private
    content (the same truncation ``import_chain`` applies — a private-led
    page can never be matched on the target). Block tables are
    positional, so chain position ``i`` is ``pages_of(rid)[i]``.
    """
    alloc = engine.allocator
    owned = alloc.pages_of(req.rid)
    usable = min(req.prefilled, req.prompt_tokens)
    exec_ = engine.executor
    can_payload = hasattr(exec_, "export_page_payload") and \
        getattr(exec_, "supports_prefix_cache", False)
    manifest: list[PageRecord] = []
    for i, (runs, ptoks) in enumerate(
            iter_page_runs(req.content_chunks(), alloc.page_size)):
        if ptoks < alloc.page_size or i >= len(owned):
            break                       # partial/unallocated tail
        if (i + 1) * alloc.page_size > usable:
            break                       # page not fully prefilled yet
        if not _shareable(runs[0][0]):
            break                       # private-led: unmatchable
        payload = None
        if can_payload:
            payload = exec_.export_page_payload([owned[i]])[0]
        manifest.append(
            PageRecord(i, runs, ptoks, payload).seal())
        if any(not _shareable(cid) for cid, _o, _l in runs):
            break   # mixed boundary page: donor only, chain ends here
    return manifest


def _corrupted(rec: PageRecord) -> PageRecord:
    """What a corrupt chunk delivers on the wire: same record with one
    payload byte flipped (or, with no payload, a tampered checksum) —
    verification then genuinely fails, it is not merely declared to."""
    if rec.payload:
        bad = bytearray(rec.payload)
        bad[0] ^= 0xFF
        return PageRecord(rec.index, rec.runs, rec.tokens, bytes(bad),
                          rec.checksum)
    return PageRecord(rec.index, rec.runs, rec.tokens, None,
                      rec.checksum ^ 0x1)


def simulate_transfer(manifest: list[PageRecord], rid: str, start: float,
                      cfg: MigrationConfig, plan=None,
                      src_kill: float | None = None,
                      dst_kill: float | None = None) -> MigrationResult:
    """Run the chunked transfer protocol on the simulated clock.

    Returns the verified delivered prefix and when it landed. Chunks are
    sent in order; a chunk is retried (backoff doubling) while
    ``plan.migration_fault`` faults it, and the transfer degrades to the
    verified prefix when retries exhaust (``fallback``). A source death
    (``src_kill``) cuts the stream — already-verified chunks remain
    importable; a target death (``dst_kill``) aborts the import wholesale.
    """
    res = MigrationResult(status="migrated", finish_time=start)
    if not manifest:
        res.status = "fallback"
        return res
    t = start
    chunks = [manifest[i:i + cfg.chunk_pages]
              for i in range(0, len(manifest), cfg.chunk_pages)]
    for ci, chunk in enumerate(chunks):
        xfer = cfg.chunk_latency_s + len(chunk) / cfg.bandwidth_pages_per_s
        attempt = 0
        while True:
            fault = (plan.migration_fault(rid, ci, attempt)
                     if plan is not None else None)
            dur = cfg.chunk_timeout_s if fault == "timeout" else xfer
            # a replica dying mid-attempt means the attempt never
            # completes: cut the stream at the last verified chunk
            if dst_kill is not None and t + dur > dst_kill:
                res.status = "aborted_target_dead"
                return res
            if src_kill is not None and t + dur > src_kill:
                res.status = "aborted_source_dead"
                return res
            if fault == "timeout":
                t += dur                      # the chunk never arrives
                ok = False
            else:
                t += dur
                wire = [(_corrupted(r) if fault == "corrupt" else r)
                        for r in chunk]
                ok = all(record_checksum(r) == r.checksum for r in wire)
            res.chunks_sent += 1
            if ok:
                res.delivered.extend(chunk)
                res.finish_time = t
                break
            res.retries += 1
            if attempt >= cfg.max_retries:
                res.status = "fallback"       # keep the verified prefix
                return res
            t += cfg.retry_backoff_s * (2 ** attempt)
            attempt += 1
    return res


def warm_import(src_engine, dst_engine, start: float,
                cfg: MigrationConfig, plan=None,
                max_pages: int = 256) -> MigrationResult:
    """Warm a restarted replica's prefix trie from a healthy peer:
    ship the peer's hottest cached chains over the same
    chunked/verified page-chain protocol a migration uses and install
    them zero-ref/evictable on the target (``import_chain`` dedupes, so
    re-warming is idempotent). Purely a latency optimization — any
    truncation (faults, capacity) just means a colder cache on rejoin;
    the pages are owned by nobody, so nothing can leak. Returns one
    aggregate result; ``finish_time`` is when the last verified chunk
    landed (the fleet gates rejoin on it)."""
    total = MigrationResult(status="migrated", finish_time=start)
    chains = src_engine.allocator.export_hot_chains(max_pages)
    exec_ = src_engine.executor
    can_payload = hasattr(exec_, "export_page_payload") and \
        getattr(exec_, "supports_prefix_cache", False)
    t = start
    for ci, chain in enumerate(chains):
        manifest = []
        for i, (runs, ptoks, page) in enumerate(chain):
            payload = (exec_.export_page_payload([page])[0]
                       if can_payload else None)
            manifest.append(PageRecord(i, runs, ptoks, payload).seal())
        res = simulate_transfer(manifest, f"warm-{ci}", t, cfg, plan)
        total.chunks_sent += res.chunks_sent
        total.retries += res.retries
        t = max(t, res.finish_time)
        if res.delivered:
            by_index = {r.index: r for r in res.delivered}
            installed = dst_engine.allocator.import_chain(
                [(r.runs, r.tokens) for r in res.delivered])
            fresh_pages, fresh_payloads = [], []
            for idx, page, fresh in installed:
                if fresh:
                    total.pages_imported += 1
                    rec = by_index[idx]
                    if rec.payload is not None:
                        fresh_pages.append(page)
                        fresh_payloads.append(rec.payload)
                else:
                    total.pages_deduped += 1
            if fresh_pages and hasattr(dst_engine.executor,
                                       "import_page_payload"):
                dst_engine.executor.import_page_payload(fresh_pages,
                                                        fresh_payloads)
            if getattr(dst_engine, "journal", None) is not None:
                dst_engine.journal.record(t, "migrate_in", f"warm-{ci}",
                                          len(installed))
        if res.status != "migrated":
            total.status = "fallback"
    total.finish_time = t
    return total


def apply_to_target(engine, req: Request, res: MigrationResult) -> None:
    """Install the delivered verified prefix on the target engine and arm
    the request's transfer hold. Safe for any delivered prefix (including
    empty — a pure fallback just re-prefills everything); never called
    for ``aborted_target_dead``.
    """
    if res.status == "aborted_target_dead":
        return
    if res.delivered:
        by_index = {r.index: r for r in res.delivered}
        installed = engine.allocator.import_chain(
            [(r.runs, r.tokens) for r in res.delivered])
        fresh_pages, fresh_payloads = [], []
        for idx, page, fresh in installed:
            if fresh:
                res.pages_imported += 1
                rec = by_index[idx]
                if rec.payload is not None:
                    fresh_pages.append(page)
                    fresh_payloads.append(rec.payload)
            else:
                res.pages_deduped += 1
        if fresh_pages and hasattr(engine.executor, "import_page_payload"):
            engine.executor.import_page_payload(fresh_pages, fresh_payloads)
        if getattr(engine, "journal", None) is not None:
            # informational (replay no-op): the chain enters the target's
            # *cache*, not the rid's ownership — the request re-claims it
            # through ordinary admission, which journals the acquire
            engine.journal.record(res.finish_time, "migrate_in", req.rid,
                                  len(res.delivered))
        # only a transfer that landed something holds the request; a pure
        # fallback is a plain re-dispatch (nothing to wait for)
        req.ready_floor = res.finish_time


def migrate(src_engine, dst_engine, req: Request, start: float,
            cfg: MigrationConfig, plan=None,
            src_kill: float | None = None,
            dst_kill: float | None = None) -> MigrationResult:
    """Full migration of one non-terminal request: snapshot the manifest,
    release every source-side resource (exactly once), run the transfer,
    install the verified prefix on the target, and reset the request for
    re-dispatch with its transfer hold armed.

    The caller routes the request to ``dst_engine``'s pending list
    afterwards — except on ``aborted_target_dead``, where nothing was
    installed and the request must go to a *different* replica (its
    ``ready_floor`` stays 0: no transfer landed anywhere).
    """
    manifest = build_manifest(src_engine, req)
    src_engine.export_request(req)
    req.reset_for_redispatch()
    res = simulate_transfer(manifest, req.rid, start, cfg, plan,
                            src_kill, dst_kill)
    if res.status != "aborted_target_dead":
        apply_to_target(dst_engine, req, res)
        if res.delivered:
            req.migrations += 1
    return res
