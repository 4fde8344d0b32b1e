"""Queue Manager (paper §3.5) with O(1) hot-path bookkeeping.

Three independent FIFO queues (trucks, cars, motorcycles) with queue-level
metrics (length, waiting time, aggregate estimated prefill). FCFS is
preserved *within* each queue; cross-queue ordering is delegated to the
Priority Regulator via the scheduler.

The seed backed each queue with a ``deque`` whose ``remove`` was O(N) per
admission. Queues are now insertion-ordered dicts (O(1) push / remove /
membership) with incrementally-maintained aggregates, and they notify an
attached ``listener`` (the engine's ``WaitingIndex``, see core/ordering.py)
so the scheduler's rank order stays incremental too.
"""
from __future__ import annotations

from repro_torch.serving.request import Request, VehicleClass


class ClassQueue:
    """One class's FIFO: insertion-ordered dict keyed by rid, plus cached
    aggregate sums (est_prefill, enqueue_time) for O(1) queue metrics."""
    __slots__ = ("_reqs", "est_prefill_sum", "enqueue_sum")

    def __init__(self):
        self._reqs: dict[str, Request] = {}
        self.est_prefill_sum = 0.0
        self.enqueue_sum = 0.0

    def push(self, req: Request) -> None:
        self._reqs[req.rid] = req
        self.est_prefill_sum += req.est_prefill
        self.enqueue_sum += req.enqueue_time

    def remove(self, req: Request) -> None:
        del self._reqs[req.rid]
        self.est_prefill_sum -= req.est_prefill
        self.enqueue_sum -= req.enqueue_time
        if not self._reqs:  # pin cached float sums on empty
            self.est_prefill_sum = 0.0
            self.enqueue_sum = 0.0

    def head(self) -> Request | None:
        return next(iter(self._reqs.values())) if self._reqs else None

    def __contains__(self, req: Request) -> bool:
        return req.rid in self._reqs

    def __len__(self) -> int:
        return len(self._reqs)

    def __iter__(self):
        return iter(self._reqs.values())

    def __getitem__(self, i: int) -> Request:
        if i == 0:
            head = self.head()
            if head is not None:
                return head
            raise IndexError(i)
        return list(self._reqs.values())[i]


class QueueManager:
    def __init__(self):
        self.queues: dict[VehicleClass, ClassQueue] = {
            v: ClassQueue() for v in VehicleClass}
        self.listener = None  # WaitingIndex attached by the engine
        self._len = 0

    def push(self, req: Request, now: float) -> None:
        assert req.vclass is not None, "classify before enqueue"
        req.enqueue_time = now
        self.queues[req.vclass].push(req)
        self._len += 1
        if self.listener is not None:
            self.listener.on_push(req, now)

    def remove(self, req: Request) -> None:
        self.queues[req.vclass].remove(req)
        self._len -= 1
        if self.listener is not None:
            self.listener.on_remove(req)

    def __len__(self) -> int:
        return self._len

    def peek_all(self) -> list[Request]:
        return [r for q in self.queues.values() for r in q]

    def heads(self) -> list[Request]:
        """FCFS head of each class queue (candidates for cross-queue pick)."""
        return [q.head() for q in self.queues.values() if q]

    def metrics(self, now: float) -> dict:
        """Queue-level aggregates from the cached sums — O(classes), not
        O(requests) (float drift vs. a fresh sum is ~ulp-scale)."""
        out = {}
        for v, q in self.queues.items():
            n = len(q)
            avg_wait = max(0.0, now - q.enqueue_sum / n) if n else 0.0
            out[v.value] = {
                "len": n,
                "avg_wait": avg_wait,
                "est_prefill_sum": q.est_prefill_sum,
            }
        return out
