"""Incremental ordering structures for the scheduling hot path (DESIGN.md).

The seed engine re-sorted the entire waiting set with freshly recomputed
exp/log ranks every iteration and re-ranked the whole running pool for
every preemption probe — O(N log N)-per-iteration host overhead that
dominates at production queue depths. This module makes the per-iteration
bookkeeping near-constant:

``WaitingIndex``
    An incremental view of the waiting set, consumed lazily in policy rank
    order (only as many candidates as the token budget admits are ever
    drawn). Two modes:

    * static — one tombstoned heap keyed on the policy's push-time rank.
      fcfs / edf / static-priority ranks never change while a request sits
      in the queue, so the cross-request order is frozen at enqueue.
    * merge — per-class tombstoned heaps whose *within-class* key is
      time-invariant (the paper's §3.5–3.6 insight: TCM scores are monotone
      in waiting time, so FCFS-within-class order never changes); only the
      *cross-class* order ages, and that needs just a 3-way compare of the
      class heads at the current clock (tcm / naive-aging).

    One float subtlety makes "monotone" non-strict: the TCM aging term
    saturates (``1 - exp(-k·w^p)`` rounds to exactly 1.0 once the wait is
    large — ~6.6 s for motorcycles), after which every saturated request of
    a class shares one score and the seed's sort falls back to *arrival*
    order, which can differ from enqueue order after preemption requeues.
    Merge mode therefore keeps a per-class ``sat`` heap keyed by arrival
    for entries whose score has reached the class floor (it can never
    change again), and resolves transient equal-score plateaus by scanning
    the (contiguous, short) run — bit-exact against the brute-force sort.

``VictimView``
    A rank-sorted snapshot of the running+prefilling pool at one clock
    reading, so repeated ``pick_victim`` probes within an iteration cost an
    amortized scan instead of a full re-rank per probe.

Both reproduce the seed's brute-force ordering bit-for-bit, including
stable-sort tie behaviour (vehicle-class enum order, FIFO within class,
prefilling-before-waiting, first-maximal-element victim ties);
tests/test_scheduler_incremental.py enforces this against the
``SchedulerPolicy.order`` / ``pick_victim`` oracles.
"""
from __future__ import annotations

import heapq
from bisect import insort

from repro_torch.serving.request import Request, VehicleClass

# Enum order (motorcycle, car, truck) — identical to the QueueManager's
# class-queue iteration order, which is what the seed's stable sort used to
# break rank ties.
_CLS_INDEX = {v: i for i, v in enumerate(VehicleClass)}
_NUM_CLS = len(_CLS_INDEX)


class _Entry:
    """One queued request inside a WaitingIndex heap."""
    __slots__ = ("req", "key", "cls", "seq", "alive", "deferred",
                 "saturated", "hkey", "hkey_now")

    def __init__(self, req: Request, cls: int, seq: int):
        self.req = req
        self.cls = cls
        self.seq = seq          # per-class push counter: FIFO tiebreak
        self.key = None
        self.alive = True       # tombstone flag (False once dequeued)
        self.deferred = False   # pushed during the current plan: the seed's
        self.saturated = False  # candidate snapshot excluded such requests
        self.hkey = None        # head-key memo (merge mode), keyed by clock
        self.hkey_now = None


class WaitingIndex:
    """Incremental rank-ordered view of the waiting set.

    Attach as ``QueueManager.listener``; consume between ``begin_plan`` and
    ``end_plan`` via ``next_candidate``. Drawing a candidate does not
    dequeue it — drawn entries are buffered and restored by ``end_plan``,
    so candidates that fail admission stay queued.

    Clock contract: ``begin_plan``/``next_candidate`` times must be
    non-decreasing across calls (the engine clock is monotone) — once an
    entry's ``ready_at`` has passed, or its score has saturated, it stays
    that way.
    """

    def __init__(self, static_key=None, within_key=None, head_key=None,
                 score_floor=None):
        if (static_key is None) == (within_key is None):
            raise ValueError("exactly one of static_key/within_key required")
        self._static_key = static_key     # req -> rank frozen at push
        self._within_key = within_key     # (req, seq) -> within-class key
        self._head_key = head_key         # (req, now) -> policy.rank(req, now)
        self._merge = static_key is None
        if self._merge:
            self._heaps: list[list] = [[] for _ in range(_NUM_CLS)]
            self._staged: list = [None] * _NUM_CLS
            if score_floor is not None:
                # terminal (saturated) score per class index; head_key[0]
                # equal to it can never change again
                self._floors = [score_floor[v] for v in VehicleClass]
                self._sats: list[list] | None = [[] for _ in range(_NUM_CLS)]
            else:
                self._floors = None
                self._sats = None
        else:
            self._heap: list = []
        self._pending: list = []          # (ready_at, cls, seq, entry)
        self._entries: dict[str, _Entry] = {}
        self._seq = [0] * _NUM_CLS
        self._in_plan = False
        self._deferred: list[_Entry] = []
        self._popped: list[_Entry] = []

    def __len__(self) -> int:
        return len(self._entries)

    # -- queue events ------------------------------------------------------
    def on_push(self, req: Request, now: float) -> None:
        cls = _CLS_INDEX[req.vclass]
        self._seq[cls] += 1
        e = _Entry(req, cls, self._seq[cls])
        assert req.rid not in self._entries, f"{req.rid} double-queued"
        self._entries[req.rid] = e
        if self._in_plan:
            e.deferred = True
            self._deferred.append(e)
        if req.ready_at > now:
            heapq.heappush(self._pending, (req.ready_at, cls, e.seq, e))
        else:
            self._insert(e)

    def on_remove(self, req: Request) -> None:
        e = self._entries.pop(req.rid, None)
        if e is not None:
            e.alive = False

    # -- internals ---------------------------------------------------------
    def _insert(self, e: _Entry) -> None:
        if not self._merge:
            e.key = (self._static_key(e.req), e.cls, e.seq)
            heapq.heappush(self._heap, (e.key, e))
        elif e.saturated:
            heapq.heappush(self._sats[e.cls], ((e.req.arrival, e.seq), e))
        else:
            e.key = self._within_key(e.req, e.seq)
            heapq.heappush(self._heaps[e.cls], (e.key, e))

    def _mature(self, now: float) -> None:
        pend = self._pending
        while pend and pend[0][0] <= now:
            e = heapq.heappop(pend)[3]
            if e.alive:
                self._insert(e)

    def _live_head(self, h: list) -> _Entry | None:
        """Live, non-deferred head of one heap."""
        while h:
            e = h[0][1]
            if not e.alive:
                heapq.heappop(h)
            elif e.deferred:
                self._popped.append(heapq.heappop(h)[1])
            else:
                return e
        return None

    def _hkey(self, e: _Entry, now: float):
        if e.hkey_now != now:
            e.hkey = self._head_key(e.req, now)
            e.hkey_now = now
        return e.hkey

    def _stage_class(self, cls: int, now: float) -> _Entry | None:
        """Extract (and cache) this class's oracle-best entry."""
        e = self._staged[cls]
        if e is not None:
            if e.alive:
                return e
            self._staged[cls] = None
        uns = self._heaps[cls]
        if self._sats is not None:
            sat = self._sats[cls]
            floor = self._floors[cls]
            # migrate the permanently-saturated prefix (score monotonically
            # non-decreasing along within-key order, so it is a prefix)
            while True:
                e = self._live_head(uns)
                if e is None or self._hkey(e, now)[0] != floor:
                    break
                heapq.heappop(uns)
                e.saturated = True
                heapq.heappush(sat, ((e.req.arrival, e.seq), e))
            e = self._live_head(sat)
            if e is not None:
                # floor score <= any unsaturated score: class-best for sure
                heapq.heappop(sat)
                self._staged[cls] = e
                return e
        e0 = self._live_head(uns)
        if e0 is None:
            return None
        heapq.heappop(uns)
        if self._sats is not None:
            # transient equal-score plateau (float-quantized aging near
            # saturation): the seed's sort orders such ties by arrival, not
            # enqueue — resolve over the contiguous run
            s0 = self._hkey(e0, now)[0]
            run = [e0]
            while True:
                e = self._live_head(uns)
                if e is None or self._hkey(e, now)[0] != s0:
                    break
                run.append(heapq.heappop(uns)[1])
            e0 = min(run, key=lambda x: self._hkey(x, now))
            for e in run:
                if e is not e0:
                    heapq.heappush(uns, (e.key, e))
        self._staged[cls] = e0
        return e0

    # -- plan-scoped ordered consumption -----------------------------------
    def begin_plan(self, now: float) -> None:
        self._in_plan = True
        self._mature(now)

    def next_candidate(self, now: float):
        """(rank, request) for the next ready waiting request in policy
        rank order, or None when exhausted. ``rank`` compares like
        ``policy.rank(request, now)``."""
        if not self._merge:
            h = self._heap
            while h:
                key, e = heapq.heappop(h)
                if not e.alive:
                    continue
                self._popped.append(e)
                if not e.deferred:
                    return key[0], e.req
            return None
        best_e, best_key, best_cls = None, None, -1
        for cls in range(_NUM_CLS):
            e = self._stage_class(cls, now)
            if e is None:
                continue
            k = (self._hkey(e, now), cls)
            if best_e is None or k < best_key:
                best_e, best_key, best_cls = e, k, cls
        if best_e is None:
            return None
        self._staged[best_cls] = None
        self._popped.append(best_e)
        return best_e.hkey, best_e.req

    def end_plan(self) -> None:
        if self._merge:
            for cls in range(_NUM_CLS):
                e = self._staged[cls]
                if e is not None:
                    if e.alive:
                        self._insert(e)
                    self._staged[cls] = None
        for e in self._popped:
            if e.alive:
                self._insert(e)
        self._popped = []
        for e in self._deferred:
            e.deferred = False
        self._deferred = []
        self._in_plan = False


class VictimView:
    """Rank-sorted view of the running+prefilling pool at one clock.

    Reproduces ``max(pool, key=rank)`` over the eligible pool exactly:
    among rank ties the entry earliest in pool order wins (``max`` returns
    the first maximal element), and additions always rank after existing
    equal-rank entries (new admissions append to the pool).
    """
    __slots__ = ("_key", "_eligible", "_dead", "_seq", "_seq_of", "_entries")

    def __init__(self, pool: list[Request], key, eligible=None):
        self._key = key
        self._eligible = eligible
        # staleness is per entry (seq), not per request: a request can be
        # preempted and re-admitted at the same clock, and only its old
        # tuple (stale rank) must stay dead
        self._dead: set[int] = set()
        self._seq = len(pool)
        self._seq_of = {r.rid: i for i, r in enumerate(pool)}
        self._entries = sorted((key(r), i, r) for i, r in enumerate(pool))

    def add(self, req: Request) -> None:
        insort(self._entries, (self._key(req), self._seq, req))
        self._seq_of[req.rid] = self._seq
        self._seq += 1

    def discard(self, req: Request) -> None:
        seq = self._seq_of.pop(req.rid, None)
        if seq is not None:
            self._dead.add(seq)

    def pick(self, bar=None, exclude: Request | None = None):
        """Highest-ranked eligible victim, or None. With ``bar`` set, the
        victim's rank must be strictly greater (strictly lower priority —
        prevents preemption cycles)."""
        entries = self._entries
        best = None
        for i in range(len(entries) - 1, -1, -1):
            key, seq, req = entries[i]
            if best is not None and key < best[0]:
                break  # keys only decrease leftwards; best is settled
            if (seq not in self._dead and req is not exclude
                    and (self._eligible is None or self._eligible(req))):
                # equal keys scan right-to-left with decreasing seq, so any
                # later hit is earlier in pool order — take it
                best = (key, seq, req)
        if best is None or (bar is not None and not best[0] > bar):
            return None
        return best[2]
