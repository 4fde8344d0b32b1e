"""Request model: lifecycle, per-request metrics, and modality metadata."""
from __future__ import annotations

import enum
from dataclasses import dataclass


class Modality(str, enum.Enum):
    TEXT = "text"
    IMAGE = "image"
    VIDEO = "video"
    AUDIO = "audio"


class VehicleClass(str, enum.Enum):
    """The paper's trucks-cars-motorcycles abstraction."""
    MOTORCYCLE = "motorcycle"
    CAR = "car"
    TRUCK = "truck"

    @property
    def static_priority(self) -> float:
        return {"motorcycle": 0.1, "car": 0.05, "truck": 0.0}[self.value]


class State(str, enum.Enum):
    WAITING = "waiting"
    ENCODING = "encoding"       # in the vision-encode queue (mm_units > 0)
    PREFILLING = "prefilling"   # admitted; chunked prefill in progress
    RUNNING = "running"         # decoding
    PREEMPTED = "preempted"
    FINISHED = "finished"
    REJECTED = "rejected"       # admission control: infeasible SLO, tenant
    #                             budget, bounded queue, or a context that
    #                             exceeds total KV capacity (see .error)
    FAILED = "failed"           # terminal: fault/capacity/shed (see .error)
    CANCELLED = "cancelled"     # terminal: client cancel / deadline expiry


#: states from which a request never leaves; every held resource (KV
#: pages, prefix-cache refs, encoder-cache pins, queue membership,
#: executor slots) must have been released exactly once on entry
TERMINAL_STATES = frozenset(
    {State.FINISHED, State.REJECTED, State.FAILED, State.CANCELLED})


@dataclass(eq=False)  # identity semantics: hashable, O(1) membership in the
class Request:        # engine's running/prefilling sets (rids are unique)
    rid: str
    modality: Modality
    arrival: float
    # input sizes (modality-specific): text tokens always; plus patches/frames
    text_tokens: int
    mm_units: int = 0          # image patches or video frames (0 for text)
    output_tokens: int = 32    # decode length target
    mm_hash: str | None = None  # content hash of the mm input (encoder-cache
    #                             key; None = uncacheable / no mm payload)
    # shared leading text (system prompt / few-shot template): identifies
    # content, so equal ids => equal tokens (KV prefix-cache key)
    shared_prefix_id: str | None = None
    shared_prefix_tokens: int = 0   # leading text tokens drawn from that id
    # multi-tenant client pool: the admission controller's
    # token buckets and the fairness metrics key on this; survives
    # redispatch (the client does not change when a replica dies)
    tenant: str = "default"

    # ---- derived / filled by the pipeline ----
    prompt_tokens: int = 0     # total LLM prompt tokens (text + mm embeds)
    preprocess_time: float = 0.0
    encode_time: float = 0.0

    # ---- estimator / classifier outputs ----
    est_prefill: float = 0.0
    est_kv_tokens: float = 0.0
    vclass: VehicleClass | None = None

    # ---- runtime state ----
    ready_at: float = 0.0      # arrival + async CPU preprocess (vLLM-style)
    state: State = State.WAITING
    prefilled: int = 0         # prompt tokens prefilled so far
    decoded: int = 0
    enqueue_time: float = 0.0  # when (re-)entered the waiting queue
    encoded_units: int = 0     # mm units encoded so far (chunked encode)
    encode_cache_hit: bool = False  # encoder output served from the cache
    cached_prefix_tokens: int = 0   # prompt tokens served from the KV
    #                                 prefix cache (advisory at ingest,
    #                                 actual claim at admission)

    # ---- metrics ----
    encode_start_time: float | None = None   # first encode chunk scheduled
    encode_finish_time: float | None = None  # last encode chunk completed
    admit_time: float | None = None          # first admission to prefilling
    first_token_time: float | None = None
    finish_time: float | None = None
    preemptions: int = 0
    preempted_time: float = 0.0
    preempted_at: float | None = None
    slo: float = float("inf")  # absolute latency target (seconds, e2e)
    slo_from_engine: bool = False  # engine-assigned (scale x isolated) vs
    #                                caller-provided: only the former may be
    #                                re-derived when cache state shifts
    # ---- fault-tolerant lifecycle ----
    deadline: float = float("inf")  # absolute hard deadline (abort past it)
    error: str | None = None        # why the request FAILED / was CANCELLED
    aborted_at: float | None = None  # terminal-abort timestamp (finish_time
    #                                  stays None: an aborted request never
    #                                  produced its full output)
    encode_faults: int = 0          # injected encoder-chunk failures seen
    step_faults: int = 0            # executor-step retries charged to it
    redispatches: int = 0           # replica-failover re-dispatch count
    # ---- fleet tier / migration ----
    migrations: int = 0             # live page-chain migrations survived
    ready_floor: float = 0.0        # earliest admissible time on the target
    #                                 replica: a migrated request only
    #                                 becomes schedulable once its chain
    #                                 transfer completes (absolute seconds;
    #                                 0.0 = no hold, the bit-exact default)
    _chunks_cache: tuple | None = None  # memoized content_chunks()

    @property
    def is_terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    def reset_for_redispatch(self) -> None:
        """Restart the lifecycle on a surviving replica after its original
        replica died: all progress (encode, prefill, decode, cache claims)
        lived in the dead replica's memory and is gone. Arrival (and any
        caller-provided SLO/deadline) is preserved — the client has been
        waiting since then — while engine-assigned SLOs reset so the new
        replica re-derives them from its own cache state."""
        self.state = State.WAITING
        self.prefilled = 0
        self.decoded = 0
        self.encoded_units = 0
        self.encode_cache_hit = False
        self.cached_prefix_tokens = 0
        self.enqueue_time = 0.0
        self.ready_at = 0.0
        self.encode_start_time = None
        self.encode_finish_time = None
        self.admit_time = None
        self.first_token_time = None
        self.finish_time = None
        self.aborted_at = None
        self.error = None
        self.preempted_at = None
        self.encode_faults = 0
        self.ready_floor = 0.0   # migration may re-apply a transfer hold
        if self.slo_from_engine:
            self.slo = float("inf")
            self.slo_from_engine = False
        self.redispatches += 1

    def content_chunks(self) -> tuple:
        """The prompt as ``(content_id, tokens)`` segments in canonical
        MLLM order — [shared system prefix][mm payload][private text] —
        the structural identity the KV prefix cache hashes page-by-page.
        Ids are equal across requests exactly when the underlying content
        is (same system prompt / same mm input); private segments carry a
        ``!`` and the rid, so they can never match another request.
        Cached: the layout is fixed at construction and this sits on the
        per-request scheduling hot path."""
        if self._chunks_cache is not None:
            return self._chunks_cache
        chunks = []
        used = 0
        if self.shared_prefix_tokens > 0 and self.shared_prefix_id:
            n = min(self.shared_prefix_tokens, self.prompt_tokens)
            chunks.append((f"sys:{self.shared_prefix_id}", n))
            used += n
        if self.mm_units > 0 and used < self.prompt_tokens:
            cid = (f"mm:{self.mm_hash}" if self.mm_hash
                   else f"mm!{self.rid}")
            n = min(self.mm_units, self.prompt_tokens - used)
            chunks.append((cid, n))
            used += n
        if used < self.prompt_tokens:
            chunks.append((f"txt!{self.rid}", self.prompt_tokens - used))
        self._chunks_cache = tuple(chunks)
        return self._chunks_cache

    def residual_sizes(self, cached_tokens: int) -> tuple[int, int]:
        """(text_tokens, mm_units) NOT covered by a cached prefix of
        ``cached_tokens`` — what the classifier should rank: a fully
        cached video has the residual prefill of a text request."""
        rem_mm = 0
        off = 0
        for cid, n in self.content_chunks():
            if cid.startswith("mm"):
                rem_mm += n - max(0, min(n, cached_tokens - off))
            off += n
        rem_text = max(0, self.prompt_tokens - cached_tokens) - rem_mm
        return max(0, rem_text), max(0, rem_mm)

    def ttft(self) -> float | None:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival

    def e2e(self) -> float | None:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival

    def norm_latency(self) -> float | None:
        """Seconds per output token (the paper's 'normalized latency')."""
        e2e = self.e2e()
        if e2e is None or self.output_tokens == 0:
            return None
        return e2e / self.output_tokens

    def slo_violated(self) -> bool:
        e2e = self.e2e()
        return e2e is not None and e2e > self.slo

    def violation_severity(self) -> float:
        e2e = self.e2e()
        if e2e is None:
            return 0.0
        return max(0.0, e2e - self.slo)

    def waiting_time(self, now: float) -> float:
        return max(0.0, now - self.enqueue_time)

    def ttft_breakdown(self) -> dict | None:
        """TTFT split into pipeline stages (paper Fig. 6, but measured on
        the live engine rather than isolated runs): preprocess, encode
        queue wait, encode, prefill queue wait, and prefill — the prefill
        term absorbs preemption/requeue time after the first admission."""
        if self.first_token_time is None:
            return None
        pre = max(0.0, self.ready_at - self.arrival)
        if self.encode_start_time is not None:
            enc_end = self.encode_finish_time
            if enc_end is None:
                enc_end = self.encode_start_time
            enc_wait = max(0.0, self.encode_start_time - self.ready_at)
            enc = max(0.0, enc_end - self.encode_start_time)
            queued_from = enc_end
        else:  # text-only, or encoder-cache hit (encode skipped entirely)
            enc_wait = enc = 0.0
            queued_from = self.ready_at
        admit = self.admit_time
        if admit is None:
            admit = self.first_token_time
        return {
            "preprocess": pre,
            "encode_wait": enc_wait,
            "encode": enc,
            "queue_wait": max(0.0, admit - queued_from),
            "prefill": max(0.0, self.first_token_time - admit),
        }
