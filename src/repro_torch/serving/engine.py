"""Continuous-batching serving engine (vLLM-style) with pluggable
scheduling policy — the substrate TCM-Serve plugs into.

Per iteration (vLLM V1 semantics with chunked prefill):
  1. ingest arrivals: classify (estimator+classifier), assign SLO, enqueue —
     multimodal requests whose encoder output is not already cached enter
     the ENCODING stage (their own modality-aware queue) instead of the
     prefill queue;
  2. the encode plan draws encoding requests in policy rank order under a
     per-iteration patch budget (chunked, so a rock's encode is preemptible
     at chunk boundaries); the prefill plan orders waiting+preempted
     requests and admits them under the iteration token budget and the KV
     page allocator; under memory pressure the policy picks preemption
     victims (recompute-style eviction, as vLLM);
  3. the executor runs the batch (sim cost model or real JAX) and the clock
     advances; encode chunks overlap with LLM prefill/decode (max- rather
     than sum-composition of stage times, RServe-style);
  4. encode-complete requests move to the prefill queue; requests finishing
     prefill emit their first token that iteration (TTFT); decoding
     requests emit one token per iteration.

A ref-counted KV prefix cache spans the allocator, scheduler, and
executors (DESIGN.md §KV prefix cache): completed prefills publish their
page chains, later requests sharing a page-aligned prefix claim those
pages (copy-on-write at the boundary page) and prefill only the residual,
and the classifier/SLO rank them by that residual — so a duplicate video
(rock) competes like the sand its remaining work is. Cache hits change
*when* work happens, never what is emitted; ``prefix_cache=False`` and the
legacy paths below stay bit-identical oracles.

Scheduling bookkeeping is incremental (DESIGN.md §Incremental scheduling
core): the waiting set lives in a ``WaitingIndex`` consumed lazily in rank
order (no per-iteration global sort), running/prefilling membership is
O(1) (insertion-ordered dicts), KV grows only at page boundaries instead
of one allocator call per decoded token, and preemption probes go through
a rank-sorted ``VictimView``. ``EngineConfig.legacy_scheduling=True``
routes planning through the seed's brute-force path — kept as the
equivalence oracle and benchmark baseline; scheduling decisions are
bit-identical either way (benchmarks/scheduler_overhead.py enforces it).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field

from repro_torch.cache import BlockAllocator, OutOfPages
from repro_torch.core.queues import QueueManager
from repro_torch.core.scheduler import SchedulerPolicy
from repro_torch.serving.encoder_cache import EncoderCache
from repro_torch.serving.journal import Journal
from repro_torch.serving.request import (TERMINAL_STATES, Request, State,
                                   VehicleClass)


@dataclass
class EngineConfig:
    token_budget: int = 2048        # chunked-prefill budget per iteration
    max_num_seqs: int = 64          # max concurrently running requests
    kv_pages: int = 24576           # KV capacity (pages); ~393k tokens at
    page_size: int = 16             # 16 tok/page (A100-40GB, 7B-class model)
    slo_scale: float = 5.0          # SLO = scale x isolated E2E (paper)
    max_preemptions_per_iter: int = 4
    # beyond-paper (EXPERIMENTS §Serving-perf): while latency-critical
    # (motorcycle) requests are decoding, shrink the prefill share of the
    # iteration so their inter-token latency stays near isolated speed.
    decode_priority: bool = False
    decode_priority_frac: float = 0.6
    # decoupled vision-encode stage: per-iteration encode budget
    # in mm units (patches) — a rock's encode yields at chunk boundaries
    # instead of monopolizing the iteration. ~2048 patches costs about as
    # much as a full 512-token prefill budget on the calibrated model.
    encode_budget: int = 2048
    # encoder-output cache ("pebble cache"): dedup repeated mm inputs by
    # content hash; a hit skips the ENCODING stage entirely
    encoder_cache: bool = True
    encoder_cache_entries: int = 256
    # KV prefix cache: completed prefills publish their page
    # chains into the allocator's content-keyed index; later requests
    # sharing a page-aligned prefix (same system prompt / same mm input)
    # claim those pages ref-counted instead of re-prefilling them, and the
    # scheduler ranks them by the *residual* prefill — a fully-cached
    # video drops from rock to sand priority. Only takes effect when the
    # executor can share KV (``supports_prefix_cache``); hits change when
    # work happens, never what is emitted.
    prefix_cache: bool = True
    prefix_residual_classify: bool = True   # ablation: rank by full cost
    # seed's brute-force planning (full re-sort + per-token allocate):
    # the decision-equivalence oracle and host-overhead baseline
    legacy_scheduling: bool = False
    # fault-tolerant lifecycle: bounded retry-with-backoff for
    # transient encoder/executor faults. The backoff is simulated clock
    # time (doubling per attempt); past the retry cap an encoder fault
    # fails the request, an executor fault fails the batch.
    max_encode_retries: int = 3
    max_step_retries: int = 3
    retry_backoff_s: float = 0.05
    # graceful load shed under *sustained* page pressure (admission
    # blocked on pages for shed_after_iters consecutive iterations):
    # shed waiting rocks first — trucks, then cars, never motorcycles —
    # so sand keeps flowing. Since overload control landed this knob is a legacy alias:
    # it maps onto the brownout ladder (admission.legacy_shed_config)
    # with the shed stage only, reproducing the original shed cadence exactly.
    # Off by default: fault-free runs stay bit-identical.
    load_shed: bool = False
    shed_after_iters: int = 40
    # overload control: an AdmissionConfig installs the
    # SLO-aware admission controller (per-tenant token buckets, bounded
    # per-class queues, TTFT feasibility at ingest — refused requests go
    # terminal REJECTED through the exactly-once release path); a
    # BrownoutConfig tunes the graded-degradation ladder driven by
    # sustained page pressure. ``admission`` alone arms the default
    # ladder; both None (and load_shed off) = no overload control, the
    # bit-identical historical path.
    admission: object | None = None   # AdmissionConfig
    brownout: object | None = None    # BrownoutConfig
    # lifecycle journal: append-only log of every state
    # transition and resource acquire/release, replayable into a second
    # independent accounting oracle (serving/journal.py). Pure recording
    # — no RNG, no clock reads the engine acts on — so a journal-enabled
    # run stays bit-identical to the same run without it.
    journal: bool = False


@dataclass
class Engine:
    policy: SchedulerPolicy
    executor: object
    classifier: object
    config: EngineConfig = field(default_factory=EngineConfig)
    # fault-injection plan (serving/faults.py) or None. Every hook below
    # is gated on ``faults is not None`` so the fault-free hot path pays
    # a single pointer check; an installed-but-empty FaultPlan() changes
    # nothing either (tests/test_faults.py gates both bit-exactly).
    faults: object | None = None

    def __post_init__(self):
        if self.config.encode_budget <= 0:
            # a zero budget would strand ENCODING requests forever (the
            # run loop would spin empty iterations until max_iters)
            raise ValueError("encode_budget must be positive")
        self.allocator = BlockAllocator(self.config.kv_pages,
                                        self.config.page_size)
        # paged-executor plumbing: the engine's page lists ARE the
        # executor's block tables, so the executor adopts this allocator
        # (its page ids index the executor's paged KV stores directly)
        if hasattr(self.executor, "bind_allocator"):
            self.executor.bind_allocator(self.allocator)
        self.queues = QueueManager()
        self.now = 0.0
        # insertion-ordered sets (dict keys): O(1) membership/removal while
        # iterating in the same order the seed's lists did
        self.running: dict[Request, None] = {}     # decoding
        self.prefilling: dict[Request, None] = {}  # admitted, chunked prefill
        self.finished: list[Request] = []
        self.rejected: list[Request] = []          # admission control
        self.aborted: list[Request] = []           # FAILED / CANCELLED
        self.iterations = 0
        # hardened lifecycle: deadline min-heap (lazy deletion;
        # empty when no request carries a finite deadline, so the sweep
        # is O(1) on fault-free runs), encoder-cache pins held per rid
        self._deadline_heap: list[tuple[float, int, Request]] = []
        self._deadline_seq = 0
        self._enc_pins: dict[str, str] = {}        # rid -> pinned mm_hash
        self._admit_blocked = False
        self.shed_count = 0
        # overload control: admission controller + brownout
        # ladder; the legacy load_shed knob maps onto a shed-only ladder
        from repro_torch.serving.admission import (AdmissionController,
                                             BrownoutConfig, BrownoutLadder,
                                             legacy_shed_config)
        self.admission = (AdmissionController(self.config.admission)
                          if self.config.admission is not None else None)
        bcfg = self.config.brownout
        if bcfg is None:
            if self.config.admission is not None:
                bcfg = BrownoutConfig()
            elif self.config.load_shed:
                bcfg = legacy_shed_config(self.config.shed_after_iters)
        self.ladder = BrownoutLadder(bcfg) if bcfg is not None else None
        # decoupled encode stage: its own per-class queue manager; ordering
        # reuses the policy's WaitingIndex on the fast path
        self.encode_queues = QueueManager()
        self.encoder_cache = (EncoderCache(self.config.encoder_cache_entries)
                              if self.config.encoder_cache else None)
        # KV prefix cache: needs an executor whose KV pages are actually
        # shareable (sim cost model, or the batched paged ModelExecutor;
        # the legacy dense-slot path keeps per-request caches and opts out)
        self.prefix_on = (self.config.prefix_cache and
                          getattr(self.executor, "supports_prefix_cache",
                                  True))
        # publication gate: shareable content ids seen at ingest. A chain
        # is only published through content at least two requests have
        # carried — a unique video's thousand-page chain that nothing
        # can ever match must not bloat the index or the eviction path
        # (without this, no-duplicate workloads paid ~5x scheduler host
        # overhead for zero hits)
        self._prefix_seen: dict[str, int] = {}
        # newest resident carrier per shareable head cid, for
        # retro-publication when its content turns popular
        self._cid_resident: dict[str, Request] = {}
        if self.config.legacy_scheduling:
            self.wait_index = None
            self.encode_index = None
        else:
            self.wait_index = self.policy.make_waiting_index()
            self.queues.listener = self.wait_index
            self.encode_index = self.policy.make_waiting_index()
            self.encode_queues.listener = self.encode_index
        self._victim_view = None
        self._victim_view_now = None
        # lifecycle journal: every hook below is gated on
        # ``journal is not None`` — one pointer check on the hot path
        self.journal = Journal() if self.config.journal else None

    def _jrec(self, kind: str, rid: str, data=None) -> None:
        self.journal.record(self.now, kind, rid, data)

    # ------------------------------------------------------------------
    def _ingest(self, pending: list[Request], start: int = 0) -> int:
        """Move arrived requests into the classified waiting queues.
        ``pending`` is sorted by arrival; returns the new start index (the
        seed rebuilt the whole list every iteration — O(N) per step)."""
        i, n = start, len(pending)
        while i < n and pending[i].arrival <= self.now:
            req = pending[i]
            i += 1
            vclass, est_prefill, est_kv = self.classifier.classify(
                req.modality.value, req.text_tokens, req.mm_units)
            # KV prefix cache: an advisory match (pages are only claimed
            # at admission) re-classifies by the *residual* prefill — the
            # modality-aware analogue of automatic prefix caching: a
            # duplicate video's prompt is mostly cached KV, so it ranks
            # (and gets an SLO) like the sand it now is
            if self.prefix_on:
                crossed = False
                for cid, _n in req.content_chunks():
                    if "!" in cid:
                        break
                    n_seen = self._prefix_seen.get(cid, 0) + 1
                    self._prefix_seen[cid] = n_seen
                    crossed |= n_seen == 2
                if crossed and self._publish_ok():
                    # this arrival just made some prefix content popular:
                    # if its first carrier is still resident, publish that
                    # chain now so THIS request can already claim it
                    self._retro_publish(req.content_chunks()[0][0])
            if self.prefix_on and self.config.prefix_residual_classify:
                match = self.allocator.match_prefix(
                    req.content_chunks(), self._prefix_limit(req))
                if match.tokens > 0:
                    # visible to isolated_e2e below (residual SLO); the
                    # admission-time claim overwrites it with the pages
                    # actually taken
                    req.cached_prefix_tokens = match.tokens
                    res_text, res_mm = req.residual_sizes(match.tokens)
                    vclass, est_prefill, est_kv = self.classifier.classify(
                        req.modality.value, res_text, res_mm)
            req.vclass = vclass
            req.est_prefill = est_prefill
            req.est_kv_tokens = est_kv
            # multimodal preprocess runs async on CPU (vLLM-style):
            # delays this request's readiness, not the GPU
            pre = getattr(self.executor, "preprocess_delay",
                          lambda r: 0.0)(req)
            req.preprocess_time = pre
            # a migrated request is not schedulable before its page-chain
            # transfer lands (ready_floor is 0.0 otherwise — bit-exact)
            req.ready_at = max(req.arrival + pre, req.ready_floor)
            if req.slo == float("inf"):
                req.slo = self.config.slo_scale * \
                    self.executor.isolated_e2e(req)
                req.slo_from_engine = True
            # admission control: a request whose context can never fit the
            # total KV capacity is rejected up front (vLLM errors out);
            # REJECTED rides the same exactly-once release path as every
            # other terminal state (_abort is a no-op-safe superset here)
            need = req.prompt_tokens + req.output_tokens
            if self.allocator.pages_for_tokens(need) > \
                    self.allocator.num_pages:
                self._abort(req, State.REJECTED,
                            f"CapacityExceeded: context of {need} tokens "
                            f"exceeds total KV capacity")
                continue
            # SLO-aware admission: bounded queues, tenant
            # budget, TTFT feasibility against current backlog — all
            # deterministic from engine state, so a replay re-derives
            # the identical rejection set. Runs before the deadline
            # heap / encoder pin so a refused request holds nothing.
            if self.admission is not None:
                reason = self.admission.decide(req, self)
                if reason is not None:
                    self._abort(req, State.REJECTED, reason)
                    continue
            # hardened lifecycle: plan-assigned deadline (absolute = rel
            # after arrival); caller-set deadlines are honored as-is
            if self.faults is not None and req.deadline == float("inf"):
                rel = self.faults.deadline_for(req)
                if rel is not None:
                    req.deadline = req.arrival + rel
            if req.deadline != float("inf"):
                self._deadline_seq += 1
                heapq.heappush(self._deadline_heap,
                               (req.deadline, self._deadline_seq, req))
            # pin the encoder-cache entry this request depends on: an
            # ingest hit must stay resident until the request is done
            # with its embeddings; a miss reserves the hash the pending
            # encode will insert. Released exactly once at terminal.
            if self.encoder_cache is not None and req.mm_hash is not None \
                    and req.mm_units > 0:
                self.encoder_cache.pin(req.mm_hash)
                self._enc_pins[req.rid] = req.mm_hash
                if self.journal is not None:
                    self._jrec("pin", req.rid, req.mm_hash)
            # multimodal requests encode before they can prefill; a cached
            # encoder output (same content hash) skips the stage entirely
            if req.mm_units > 0 and not self._encode_cached(req):
                req.state = State.ENCODING
                self.encode_queues.push(req, self.now)
                if self.journal is not None:
                    self._jrec("state", req.rid, State.ENCODING.value)
                if self.faults is not None and \
                        self.faults.should_cancel(req, "encoding"):
                    self._abort(req, State.CANCELLED, "client cancel "
                                "(encoding)")
            else:
                self.queues.push(req, self.now)
                if self.journal is not None:
                    self._jrec("state", req.rid, State.WAITING.value)
                if self.faults is not None and \
                        self.faults.should_cancel(req, "waiting"):
                    self._abort(req, State.CANCELLED, "client cancel "
                                "(waiting)")
        return i

    def _encode_cached(self, req: Request) -> bool:
        """Encoder-cache lookup at ingest; a hit marks the request
        fully encoded. Requests without a content hash bypass the cache."""
        if self.encoder_cache is None or req.mm_hash is None:
            return False
        if not self.encoder_cache.lookup(req.mm_hash):
            return False
        req.encode_cache_hit = True
        req.encoded_units = req.mm_units
        return True

    # -- hardened lifecycle ----------------------------------
    def _unpin_encoder(self, req: Request) -> None:
        """Release the request's encoder-cache pin (exactly once)."""
        h = self._enc_pins.pop(req.rid, None)
        if h is not None and self.encoder_cache is not None:
            self.encoder_cache.unpin(h)
        if h is not None and self.journal is not None:
            self._jrec("unpin", req.rid, h)

    def _abort(self, req: Request, state: State, error: str) -> bool:
        """Move ``req`` to a terminal FAILED/CANCELLED/REJECTED state,
        releasing every held resource exactly once: queue/membership
        indices, KV pages (incl. shared prefix-cache refs and COW claims
        — the allocator's ref counts make ``free`` safe for shared
        chains), encoder-cache pins, and executor-side slots/state.
        Idempotent: a second abort of a terminal request is a no-op.
        Admission rejections arrive here *pre-enqueue* (state WAITING but
        not yet queued), hence the membership check on queue removal.

        A cancelled/expired request whose prefill had completed still
        holds *valid* prompt KV — publish the chain first (like
        preemption does) so the work is re-monetizable; a FAILED request
        publishes nothing (its KV is suspect by definition)."""
        if req.state in TERMINAL_STATES:
            return False
        prev = req.state
        if prev in (State.WAITING, State.PREEMPTED):
            if req in self.queues.queues[req.vclass]:
                self.queues.remove(req)
        elif prev is State.ENCODING:
            self.encode_queues.remove(req)
        elif prev is State.PREFILLING:
            self.prefilling.pop(req, None)
        elif prev is State.RUNNING:
            self.running.pop(req, None)
        if self._victim_view is not None:
            self._victim_view.discard(req)
        if state is State.CANCELLED and self.prefix_on and \
                req.prefilled >= req.prompt_tokens and \
                self.allocator.owned_pages(req.rid) > 0:
            self.allocator.publish_prefix(req.rid, req.content_chunks())
        self.allocator.free(req.rid)
        req.state = state
        req.error = error
        req.aborted_at = self.now
        if hasattr(self.executor, "release_slot"):
            self.executor.release_slot(req)
        self._unpin_encoder(req)
        (self.rejected if state is State.REJECTED
         else self.aborted).append(req)
        if self.journal is not None:
            self._jrec("release", req.rid)
            self._jrec("terminal", req.rid, state.value)
        return True

    def cancel(self, req: Request, reason: str = "client cancel") -> bool:
        """Public cancellation entry point (client disconnect): abort a
        non-terminal request and release everything it holds."""
        return self._abort(req, State.CANCELLED, reason)

    # -- fleet tier ------------------------------------------
    def export_request(self, req: Request) -> bool:
        """Release every engine-side resource of a non-terminal request
        WITHOUT deciding its fate — the handoff half of drain, migration,
        and failover (the fleet re-dispatches the request elsewhere):
        queue / running / prefilling membership, KV pages (ref-aware, so
        shared prefix chains survive), encoder-cache pin, executor slot
        and per-request executor state, and the deadline-heap entry (a
        live source replica must never expire a request that now lives on
        another replica). Exactly-once via the same membership guards
        ``_abort`` uses; returns False for terminal requests (nothing to
        hand off) and for requests this engine does not hold."""
        if req.state in TERMINAL_STATES:
            return False
        prev = req.state
        if prev in (State.WAITING, State.PREEMPTED):
            # vclass is None until first ingest: a routed-but-never-
            # ingested request holds nothing here beyond the no-op
            # releases below
            if req.vclass is not None and \
                    req in self.queues.queues[req.vclass]:
                self.queues.remove(req)
        elif prev is State.ENCODING:
            if req in self.encode_queues.queues[req.vclass]:
                self.encode_queues.remove(req)
        elif prev is State.PREFILLING:
            self.prefilling.pop(req, None)
        elif prev is State.RUNNING:
            self.running.pop(req, None)
        if self._victim_view is not None:
            self._victim_view.discard(req)
        self.allocator.free(req.rid)
        if hasattr(self.executor, "release_slot"):
            self.executor.release_slot(req)
        if hasattr(self.executor, "evict_request"):
            # release_slot keeps non-terminal per-rid memos (the request
            # would normally run again HERE); an exported request never
            # does, so drop them on the source executor
            self.executor.evict_request(req.rid)
        self._unpin_encoder(req)
        if self._deadline_heap:
            self._deadline_heap = [e for e in self._deadline_heap
                                   if e[2] is not req]
            heapq.heapify(self._deadline_heap)
        if self.journal is not None:
            self._jrec("release", req.rid)
            self._jrec("export", req.rid)
        return True

    def _expire_deadlines(self) -> None:
        """Abort every non-terminal request whose hard deadline passed.
        Lazy-deleting min-heap: terminal entries pop through silently, so
        the sweep costs O(expired log n) — zero when no deadlines exist."""
        heap = self._deadline_heap
        while heap and heap[0][0] <= self.now:
            _dl, _seq, req = heapq.heappop(heap)
            if req.state not in TERMINAL_STATES:
                self._abort(req, State.CANCELLED,
                            f"deadline exceeded ({req.deadline:.3f}s)")

    def _shed_for_pressure(self) -> bool:
        """Shed stage of the brownout ladder (the absorbed load-shed policy):
        sustained page pressure climbed past every graded rung, so drop
        the biggest waiting rock — trucks first, then cars, *never*
        motorcycles — and keep the sand flowing (modality-aware
        degradation). Shedding waiting (not running) requests wastes no
        completed work. Returns True when a victim was shed (the ladder
        half-resets its streak then, so shedding stays gradual)."""
        for vclass in (VehicleClass.TRUCK, VehicleClass.CAR):
            q = self.queues.queues[vclass]
            if not len(q):
                continue
            victim = max(q, key=lambda r: (r.est_kv_tokens, r.rid))
            self._abort(victim, State.FAILED,
                        "load shed: sustained page pressure")
            self.shed_count += 1
            return True
        return False

    # ------------------------------------------------------------------
    def _victims(self):
        """Rank-sorted running+prefilling view, rebuilt when the clock
        moves and patched incrementally on admit/preempt in between."""
        if self._victim_view is None or self._victim_view_now != self.now:
            pool = list(self.running) + list(self.prefilling)
            self._victim_view = self.policy.make_victim_view(pool, self.now)
            self._victim_view_now = self.now
        return self._victim_view

    def _popular_tokens(self, chunks) -> int:
        """Token length of the leading run of content ids at least two
        ingested requests have carried — the publishable prefix."""
        total = 0
        for cid, n in chunks:
            if "!" in cid or self._prefix_seen.get(cid, 0) < 2:
                break
            total += n
        return total

    def _publish_ok(self) -> bool:
        """Brownout rung 3: pause popularity-gated prefix
        publication while the ladder holds this rung — index growth and
        its eviction bookkeeping are pure speculation under pressure.
        Preemption victims (and cancelled completed prefills) still
        self-publish: that is preservation of paid-for work, not a bet."""
        return self.ladder is None or not self.ladder.active("publication")

    def _retro_publish(self, head_cid: str) -> None:
        """Publish the still-resident first carrier of newly-popular
        content (its completion predated the popularity, so the gate
        skipped it then). Stale candidates — finished (pages freed) or
        preempted (KV dropped) — fail the guards and are ignored."""
        cand = self._cid_resident.get(head_cid)
        if cand is None or cand.prefilled < cand.prompt_tokens or \
                self.allocator.owned_pages(cand.rid) == 0:
            return
        popular = self._popular_tokens(cand.content_chunks())
        if popular > 0:
            self.allocator.publish_prefix(cand.rid, cand.content_chunks(),
                                          max_tokens=popular)

    def _prefix_limit(self, req: Request) -> int:
        """Max claimable prefix: the last prompt token must always run
        through the model (its logits emit the first output token), and
        the real executor cannot start a row past its context window."""
        limit = req.prompt_tokens - 1
        cap = getattr(self.executor, "prefix_token_limit", None)
        if cap is not None:
            limit = min(limit, cap)
        return limit

    def _try_admit(self, req: Request) -> bool:
        """Allocate KV pages for the full prompt — re-using any cached
        prefix chain ref-counted — preempting strictly lower-priority
        victims if needed (no preemption cycles). Preempting a victim
        only releases pages nobody else references, so the page math
        below is ref-aware throughout (``can_allocate`` counts evictable
        cached pages as free and ``allocate`` evicts them on demand)."""
        tokens = req.prompt_tokens
        match = None
        if self.prefix_on:
            match = self.allocator.match_prefix(
                req.content_chunks(), self._prefix_limit(req))
        tries = 0
        legacy = self.config.legacy_scheduling
        bar = None
        while not self.allocator.can_allocate(tokens, rid=req.rid,
                                              match=match):
            if tries >= self.config.max_preemptions_per_iter:
                self._admit_blocked = True
                return False
            if legacy:
                victim = self.policy.pick_victim(
                    list(self.running) + list(self.prefilling), self.now,
                    for_req=req)
            else:
                if bar is None:
                    bar = self.policy.rank(req, self.now)
                victim = self._victims().pick(bar=bar, exclude=req)
            if victim is None or victim is req:
                self._admit_blocked = True
                return False
            self._preempt(victim)
            tries += 1
        claimed, cow_dst = self.allocator.claim_prefix(req.rid, match)
        req.cached_prefix_tokens = claimed
        req.prefilled = claimed   # residual prefill only
        if claimed > 0 and hasattr(self.executor, "on_prefix_claim"):
            # the COW copy must read the donor before any later eviction
            # can hand its page out, so the hook runs pre-allocate
            self.executor.on_prefix_claim(
                req, claimed,
                match.cow_src if cow_dst is not None else None, cow_dst)
        self.allocator.allocate(req.rid, tokens)
        if self.journal is not None:
            # claim_prefix asserted the block table was empty, so the
            # post-allocate snapshot is exactly what this admission took
            self._jrec("acquire", req.rid,
                       tuple(self.allocator.pages_of(req.rid)))
        return True

    def _preempt(self, victim: Request) -> None:
        """Recompute-style eviction: drop KV, back to the waiting queue.
        A victim whose prefill had completed publishes its chain first
        (popularity-exempt: the one future request guaranteed to want
        these exact pages is the victim itself), so unless real pressure
        evicts them, re-admission re-claims instead of re-prefilling."""
        if self.prefix_on and victim.prefilled >= victim.prompt_tokens:
            self.allocator.publish_prefix(victim.rid,
                                          victim.content_chunks())
        self.allocator.free(victim.rid)
        self.running.pop(victim, None)
        self.prefilling.pop(victim, None)
        if self._victim_view is not None:
            self._victim_view.discard(victim)
        if hasattr(self.executor, "release_slot"):
            self.executor.release_slot(victim)
        victim.preemptions += 1
        victim.preempted_at = self.now
        victim.prefilled = 0
        victim.state = State.PREEMPTED
        self.queues.push(victim, self.now)
        if self.journal is not None:
            self._jrec("release", victim.rid)
            self._jrec("state", victim.rid, State.PREEMPTED.value)
        if self.faults is not None and \
                self.faults.should_cancel(victim, "preempted"):
            # client disconnected in the preemption window: the victim's
            # pages are already freed, so the abort only dequeues it
            self._abort(victim, State.CANCELLED,
                        "client cancel (preempted)")

    def _reprice(self, req: Request) -> None:
        """The admission-time claim diverged from the ingest advisory —
        the chain was evicted while the request queued (claim shrank) or
        published meanwhile (claim grew). Re-derive class and SLO from
        the pages actually claimed, so victim eligibility and SLO
        accounting track the work really left; caller-provided SLOs are
        never touched. Runs after the queue exit: mutating ``vclass``
        while queued would desync the per-class queues."""
        res_text, res_mm = req.residual_sizes(req.cached_prefix_tokens)
        req.vclass, req.est_prefill, req.est_kv_tokens = \
            self.classifier.classify(req.modality.value, res_text, res_mm)
        if req.slo_from_engine:
            req.slo = self.config.slo_scale * \
                self.executor.isolated_e2e(req)

    def _admit(self, req: Request) -> bool:
        """Waiting -> prefilling transition (shared by both plan paths).
        Caller checks the max_num_seqs cap first."""
        if req.state in TERMINAL_STATES:
            # cancelled/failed while a stale plan snapshot still listed
            # it (e.g. a mid-plan preemption cancel) — never resurrect
            return False
        advisory = req.cached_prefix_tokens
        if not self._try_admit(req):
            return False
        self.queues.remove(req)
        if self.prefix_on and self.config.prefix_residual_classify and \
                req.cached_prefix_tokens != advisory:
            self._reprice(req)
        if req.preempted_at is not None:
            req.preempted_time += self.now - req.preempted_at
            req.preempted_at = None
        if req.admit_time is None:
            req.admit_time = self.now
        req.state = State.PREFILLING
        self.prefilling[req] = None
        if self.journal is not None:
            self._jrec("state", req.rid, State.PREFILLING.value)
        if self._victim_view is not None and \
                self._victim_view_now == self.now:
            self._victim_view.add(req)
        return True

    # ------------------------------------------------------------------
    def _plan(self):
        """Pick this iteration's encode chunks, decode batch + prefill
        chunks."""
        encode_work = self._plan_encode()
        budget = self.config.token_budget
        decode_batch = list(self.running)
        budget -= len(decode_batch)
        if self.config.decode_priority and any(
                r.vclass is VehicleClass.MOTORCYCLE for r in decode_batch):
            # protect latency-critical inter-token latency: cap the prefill
            # share while motorcycles are decoding (beyond-paper)
            budget = min(budget, int(self.config.token_budget *
                                     self.config.decode_priority_frac))
        if self.config.legacy_scheduling:
            prefill_work = self._plan_prefill_legacy(budget)
        else:
            prefill_work = self._plan_prefill(budget)
        return prefill_work, decode_batch, encode_work

    def _plan_encode(self) -> list[tuple[Request, int]]:
        """Draw encoding requests in policy rank order and hand out encode
        chunks under the per-iteration patch budget. Nothing is held
        across iterations (no KV is allocated while encoding), so a
        higher-priority arrival simply takes the next iteration's budget
        first — rock encodes are preemptible at every chunk boundary."""
        budget = self.config.encode_budget
        work: list[tuple[Request, int]] = []
        if budget <= 0 or not len(self.encode_queues):
            return work
        # brownout rung 1: under sustained pressure, cap each
        # truck's encode chunk — rocks still make progress, but can no
        # longer monopolize the patch budget pebbles/sand are waiting on
        truck_cap = None
        if self.ladder is not None and self.ladder.active("encode"):
            truck_cap = max(1, int(budget * self.ladder.cfg.encode_chunk_frac))

        def _chunk(req: Request) -> int:
            chunk = min(budget, req.mm_units - req.encoded_units)
            if truck_cap is not None and req.vclass is VehicleClass.TRUCK:
                chunk = min(chunk, truck_cap)
            return chunk

        if self.config.legacy_scheduling:
            ordered = self.policy.order(
                [r for r in self.encode_queues.peek_all()
                 if r.ready_at <= self.now], self.now)
            for req in ordered:
                if budget <= 0:
                    break
                chunk = _chunk(req)
                if chunk > 0:
                    work.append((req, chunk))
                    budget -= chunk
            return work
        idx = self.encode_index
        idx.begin_plan(self.now)
        try:
            while budget > 0:
                head = idx.next_candidate(self.now)
                if head is None:
                    break
                chunk = _chunk(head[1])
                if chunk > 0:
                    work.append((head[1], chunk))
                    budget -= chunk
        finally:
            idx.end_plan()
        return work

    def _plan_prefill(self, budget: int):
        """One policy-ordered pass over BOTH in-flight prefills and waiting
        requests: lets a fresh motorcycle take budget ahead of a truck's
        next chunk ("reshaping batches", paper §3.1) while admitted
        requests keep their KV pages.

        The waiting set is drawn lazily from the WaitingIndex — only as
        many candidates as the budget/admission allows are ever ranked —
        and merged with a rank-sorted snapshot of the (small, capped)
        prefilling set. Ties resolve prefilling-first, exactly like the
        seed's stable sort over [prefilling] + [waiting]."""
        prefill_work: list[tuple[Request, int]] = []
        if budget <= 0:
            return prefill_work
        policy, now, cap = self.policy, self.now, self.config.max_num_seqs
        # brownout rung 2: defer admitting *waiting* trucks
        # while the ladder holds this rung — trucks already prefilling
        # keep their pages and continue (no wasted work)
        defer_trucks = (self.ladder is not None
                        and self.ladder.active("defer_trucks"))
        pre = sorted((policy.rank(r, now), i, r)
                     for i, r in enumerate(self.prefilling))
        pi, npre = 0, len(pre)
        idx = self.wait_index
        idx.begin_plan(now)
        try:
            head = idx.next_candidate(now)
            while budget > 0:
                if head is not None and (pi >= npre or
                                         head[0] < pre[pi][0]):
                    req = head[1]
                    if defer_trucks and req.vclass is VehicleClass.TRUCK \
                            and req not in self.prefilling:
                        head = idx.next_candidate(now)
                        continue
                    if len(self.running) + len(self.prefilling) >= cap:
                        # no later waiting candidate can admit either; the
                        # seed scanned and skipped them all (side-effect
                        # free), so stop drawing from the index
                        head = None
                        continue
                    if not self._admit(req):
                        head = idx.next_candidate(now)
                        continue
                    head = idx.next_candidate(now)
                elif pi < npre:
                    req = pre[pi][2]
                    pi += 1
                    if req not in self.prefilling:
                        # preempted earlier in this pass; the seed re-ran
                        # such snapshot entries through the waiting branch
                        if len(self.running) + len(self.prefilling) >= cap \
                                or not self._admit(req):
                            continue
                else:
                    break
                chunk = min(budget, req.prompt_tokens - req.prefilled)
                if chunk > 0:
                    prefill_work.append((req, chunk))
                    budget -= chunk
        finally:
            idx.end_plan()
        return prefill_work

    def _plan_prefill_legacy(self, budget: int):
        """Seed behaviour: re-sort the full candidate set every iteration
        (the host-overhead baseline the incremental path is measured
        against; decisions are identical)."""
        prefill_work: list[tuple[Request, int]] = []
        defer_trucks = (self.ladder is not None
                        and self.ladder.active("defer_trucks"))
        candidates = self.policy.order(
            list(self.prefilling) +
            [r for r in self.queues.peek_all() if r.ready_at <= self.now],
            self.now)
        for req in candidates:
            if budget <= 0:
                break
            if req not in self.prefilling:
                if defer_trucks and req.vclass is VehicleClass.TRUCK:
                    continue
                if len(self.running) + len(self.prefilling) >= \
                        self.config.max_num_seqs:
                    continue
                if not self._admit(req):
                    continue
            chunk = min(budget, req.prompt_tokens - req.prefilled)
            if chunk > 0:
                prefill_work.append((req, chunk))
                budget -= chunk
        return prefill_work

    # ------------------------------------------------------------------
    def _grow_kv(self, req: Request, total_tokens: int) -> bool:
        """Grow a decoding request's KV to ``total_tokens``. On pressure,
        preempt a strictly-eligible victim; with no victim (or if the
        retry still fails), preempt the request itself recompute-style —
        the seed crashed on an uncaught OutOfPages here.

        Livelock guard: a context that can never fit
        *total* KV capacity would be preempted, re-admitted, re-prefilled
        and re-preempted at the same point forever. Detect "cannot fit
        even from an empty allocator" up front and fail the request with
        a clear CapacityExceeded error instead — no victim can help, so
        none is punished either."""
        try:
            fresh = self.allocator.allocate(req.rid, total_tokens)
            if fresh and self.journal is not None:
                self._jrec("acquire", req.rid, tuple(fresh))
            return True
        except OutOfPages:
            pass
        if self.allocator.pages_for_tokens(total_tokens) > \
                self.allocator.num_pages:
            self._abort(
                req, State.FAILED,
                f"CapacityExceeded: context of {total_tokens} tokens "
                f"needs {self.allocator.pages_for_tokens(total_tokens)} "
                f"pages but the allocator only has "
                f"{self.allocator.num_pages}")
            return False
        if self.config.legacy_scheduling:
            victim = self.policy.pick_victim(
                [r for r in list(self.running) + list(self.prefilling)
                 if r is not req], self.now)
        else:
            victim = self._victims().pick(exclude=req)
        if victim is not None:
            self._preempt(victim)
            try:
                fresh = self.allocator.allocate(req.rid, total_tokens)
                if fresh and self.journal is not None:
                    self._jrec("acquire", req.rid, tuple(fresh))
                return True
            except OutOfPages:
                pass
        self._preempt(req)
        return False

    def _step_core(self, pending: list[Request], start: int) -> int:
        start = self._ingest(pending, start)
        if self._deadline_heap:
            self._expire_deadlines()
        if not (self.running or self.prefilling or len(self.queues)
                or len(self.encode_queues)):
            if start < len(pending):  # idle: jump to next arrival
                self.now = max(self.now, pending[start].arrival)
                start = self._ingest(pending, start)
            else:
                return start

        self._admit_blocked = False
        prefill_work, decode_batch, encode_work = self._plan()
        if self.ladder is not None:
            # one degradation ladder: graded rungs first
            # (encode shrink / truck deferral / publication tightening
            # are applied inside the planners via ladder.active), shed
            # only at the top — with hysteresis on the way down
            if self.ladder.observe(self._admit_blocked) and \
                    self._shed_for_pressure():
                self.ladder.shed_fired()
        if not (prefill_work or decode_batch or encode_work) \
                and (len(self.queues) or len(self.encode_queues)):
            # everything is waiting on async preprocess: jump ahead
            nxt = min(r.ready_at for r in self.queues.peek_all()
                      + self.encode_queues.peek_all())
            self.now = max(self.now, nxt)
            prefill_work, decode_batch, encode_work = self._plan()
        if self.faults is not None:
            # transient executor-step faults: retry with doubling backoff
            # (simulated clock time); past the cap the fault is permanent
            # for this batch — fail every request the broken step touched
            attempt = 0
            while self.faults.step_fault(self.iterations, attempt):
                if attempt >= self.config.max_step_retries:
                    self.iterations += 1
                    for req, _chunk in prefill_work:
                        req.step_faults += 1
                        self._abort(req, State.FAILED, "executor fault "
                                    "(step retries exhausted)")
                    for req in decode_batch:
                        req.step_faults += 1
                        self._abort(req, State.FAILED, "executor fault "
                                    "(step retries exhausted)")
                    for req, _units in encode_work:
                        req.step_faults += 1
                        self._abort(req, State.FAILED, "executor fault "
                                    "(step retries exhausted)")
                    return start
                self.now += self.config.retry_backoff_s * (2 ** attempt)
                attempt += 1
        plan_now = self.now
        duration = self.executor.run_iteration(prefill_work, decode_batch,
                                               encode_work)
        self.now += duration
        self.iterations += 1

        cache = self.encoder_cache
        for req, units in encode_work:
            if self.faults is not None and self.faults.encoder_fault(req):
                # this chunk's encode failed (corrupt frame, encoder OOM):
                # no unit credit; requeue with doubling backoff, and fail
                # the request terminally once the retry budget is spent
                req.encode_faults += 1
                if req.encode_faults > self.config.max_encode_retries:
                    self._abort(req, State.FAILED,
                                "encoder fault (retries exhausted)")
                else:
                    self.encode_queues.remove(req)
                    req.ready_at = self.now + self.config.retry_backoff_s \
                        * (2 ** (req.encode_faults - 1))
                    self.encode_queues.push(req, self.now)
                continue
            if req.encode_start_time is None:
                req.encode_start_time = plan_now
            req.encoded_units += units
            if req.encoded_units >= req.mm_units:
                # encode complete: leave the encode queue, enter the
                # prefill queue; the freshly-encoded output becomes
                # cacheable for later duplicates
                req.encode_finish_time = self.now
                self.encode_queues.remove(req)
                if cache is not None and req.mm_hash is not None:
                    cache.insert(req.mm_hash, req.mm_units)
                req.state = State.WAITING
                self.queues.push(req, self.now)
                if self.journal is not None:
                    self._jrec("state", req.rid, State.WAITING.value)
                if self.faults is not None and \
                        self.faults.should_cancel(req, "waiting"):
                    self._abort(req, State.CANCELLED, "client cancel "
                                "(waiting)")
        page = self.config.page_size
        legacy = self.config.legacy_scheduling
        alloc = self.allocator
        for req, chunk in prefill_work:
            if req not in self.prefilling:
                continue  # preempted later in the same planning pass
            if self.faults is not None and \
                    self.faults.should_cancel(req, "prefilling"):
                # disconnect mid-prefill (possibly holding a COW claim on
                # shared prefix pages — _abort's ref-aware free handles it)
                self._abort(req, State.CANCELLED,
                            "client cancel (prefilling)")
                continue
            req.prefilled += chunk
            if self.prefix_on and req.prefilled < req.prompt_tokens \
                    and self._publish_ok():
                # progressive in-flight publication: pages this chunk
                # completed are final KV — publishing popular content as
                # it lands lets a duplicate admitted mid-prefill already
                # share the written prefix instead of racing a second
                # full prefill (gated, so one-off content costs nothing)
                chunks = req.content_chunks()
                popular = min(self._popular_tokens(chunks),
                              (req.prefilled // page) * page)
                if popular > 0:
                    self.allocator.publish_prefix(req.rid, chunks,
                                                  max_tokens=popular)
            if req.prefilled >= req.prompt_tokens:
                req.first_token_time = self.now  # prefill iter emits token 1
                req.decoded = 1
                req.state = State.RUNNING
                del self.prefilling[req]
                self.running[req] = None
                if self.journal is not None:
                    self._jrec("state", req.rid, State.RUNNING.value)
                if self.prefix_on:
                    # the prompt KV is final (decode writes only past it):
                    # publish the page chain for later requests, truncated
                    # to the popular prefix (content ids at least two
                    # requests have carried) so one-off content never
                    # grows the index; register as the resident carrier
                    # for retro-publication if popularity comes later
                    chunks = req.content_chunks()
                    if chunks and "!" not in chunks[0][0]:
                        self._cid_resident[chunks[0][0]] = req
                    popular = (self._popular_tokens(chunks)
                               if self._publish_ok() else 0)
                    if popular > 0:
                        self.allocator.publish_prefix(req.rid, chunks,
                                                      max_tokens=popular)
                # paged coverage: next iteration's decode writes KV at
                # position prompt_tokens, so when the prompt exactly fills
                # its pages the admission allocation has no slack — grow
                # now (post-decode growth keeps the invariant thereafter)
                if req.prompt_tokens + 1 > page * alloc.owned_pages(req.rid):
                    self._grow_kv(req, req.prompt_tokens + 1)
        done = []
        for req in decode_batch:
            if req not in self.running:
                continue  # preempted mid-plan (defensive)
            if self.faults is not None and \
                    self.faults.should_cancel(req, "running"):
                self._abort(req, State.CANCELLED,
                            "client cancel (running)")
                continue
            req.decoded += 1
            total = req.prompt_tokens + req.decoded
            # KV grows only when the context outruns the pages already
            # owned (the first token after prefill rides the admission
            # allocation's slack); the seed called allocate() every token
            if (legacy or total > page * alloc.owned_pages(req.rid)) and \
                    not self._grow_kv(req, total):
                continue  # req itself was preempted (recompute)
            if req.decoded >= req.output_tokens:
                done.append(req)
        for req in done:
            if req not in self.running:
                continue  # evicted by a later decode-growth preemption
            req.finish_time = self.now
            req.state = State.FINISHED
            del self.running[req]
            self.allocator.free(req.rid)
            if self._victim_view is not None:
                self._victim_view.discard(req)
            if hasattr(self.executor, "release_slot"):
                self.executor.release_slot(req)
            self._unpin_encoder(req)
            self.finished.append(req)
            if self.journal is not None:
                self._jrec("release", req.rid)
                self._jrec("terminal", req.rid, State.FINISHED.value)
        return start

    def step(self, pending: list[Request]) -> list[Request]:
        # the cursor-based core needs arrival order; the seed's step
        # accepted any order, so sort defensively when the caller didn't
        if any(pending[i].arrival > pending[i + 1].arrival
               for i in range(len(pending) - 1)):
            pending = sorted(pending, key=lambda r: r.arrival)
        i = self._step_core(pending, 0)
        return pending[i:] if i else pending

    @property
    def idle(self) -> bool:
        """No in-flight work anywhere (the router's stepped co-simulation
        uses this to detect quiescent replicas)."""
        return not (self.running or self.prefilling or len(self.queues)
                    or len(self.encode_queues))

    def overload_state(self) -> dict:
        """Per-replica overload snapshot: the router's
        pressure-aware placement and the SLO benchmark report read this —
        and the fleet-scale open item will route on it."""
        return {
            "brownout_level": self.ladder.level if self.ladder else 0,
            "shed": self.shed_count,
            "rejected": len(self.rejected),
            "admission": (self.admission.describe()
                          if self.admission is not None else None),
            "queued": len(self.queues) + len(self.encode_queues),
        }

    # ------------------------------------------------------------------
    def run(self, requests: list[Request], max_iters: int = 2_000_000):
        pending = sorted(requests, key=lambda r: r.arrival)
        n = len(pending)
        start = 0
        it = 0
        while len(self.finished) + len(self.rejected) + \
                len(self.aborted) < n and it < max_iters:
            start = self._step_core(pending, start)
            it += 1
        return self.finished
