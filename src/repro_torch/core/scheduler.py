"""Scheduling policies: TCM-Serve and the paper's baselines.

Each policy defines a total order over requests via ``rank`` (lower = run
earlier). The engine uses the policy's *incremental* structures on the hot
path — ``make_waiting_index`` for admission order and ``make_victim_view``
for preemption under memory pressure (core/ordering.py) — while ``order``
and ``pick_victim`` remain the brute-force reference implementations: they
are the oracle the property tests compare against and the code path behind
``EngineConfig.legacy_scheduling``. Victim selection for *admission*
requires the victim to rank strictly LOWER than the candidate (prevents
preemption cycles; matches vLLM's priority preemption).

Incremental orderings per policy (bit-identical to the brute-force sort):
  * fcfs / edf / static — rank is frozen at enqueue, so one heap keyed on
    the static rank suffices.
  * tcm / naive-aging  — rank ages with waiting time, but FCFS *within* a
    class never changes (paper §3.5–3.6: scores are monotone in waiting
    time within a class), so cross-queue order needs only a lazy 3-way
    merge of the per-class FIFO heads — never a global sort.

Policies:
  * fcfs            — vLLM default (arrival order).
  * edf             — Earliest Deadline First (deadline = arrival + SLO).
  * static          — static M->C->T priority, FCFS within class.
  * naive-aging     — priority purely by age (ablation).
  * tcm             — full TCM-Serve: smart classifier + Priority Regulator
                      (aging); motorcycles are never preempted.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.serving.request import Request, VehicleClass

from .ordering import VictimView, WaitingIndex
from .regulator import EPS, PriorityRegulator

CLASS_RANK = {VehicleClass.MOTORCYCLE: 0, VehicleClass.CAR: 1,
              VehicleClass.TRUCK: 2}


class SchedulerPolicy:
    name = "base"

    def rank(self, req: Request, now: float):
        """Sortable key; lower = scheduled earlier."""
        raise NotImplementedError

    def victim_eligible(self, req: Request) -> bool:
        """May this request ever be preempted? (tcm shields motorcycles)"""
        return True

    # -- brute-force reference (oracle + legacy_scheduling path) ----------
    def order(self, waiting: list[Request], now: float) -> list[Request]:
        return sorted(waiting, key=lambda r: self.rank(r, now))

    def _victim_pool(self, running: list[Request], now: float,
                     for_req: Request | None):
        pool = running
        if for_req is not None:
            bar = self.rank(for_req, now)
            pool = [r for r in pool if self.rank(r, now) > bar]
        return pool

    def pick_victim(self, running: list[Request], now: float,
                    for_req: Request | None = None) -> Request | None:
        """Request to preempt (None = don't preempt). If ``for_req`` is
        given, only strictly lower-priority requests are eligible."""
        pool = [r for r in self._victim_pool(running, now, for_req)
                if self.victim_eligible(r)]
        if not pool:
            return None
        return max(pool, key=lambda r: self.rank(r, now))

    # -- incremental structures (engine hot path) -------------------------
    def make_waiting_index(self) -> WaitingIndex:
        """Default: rank is time-invariant while queued — freeze it at
        push (``rank(req, now)`` must not depend on ``now``)."""
        return WaitingIndex(static_key=lambda r: self.rank(r, 0.0))

    def make_victim_view(self, pool: list[Request],
                         now: float) -> VictimView:
        return VictimView(pool, key=lambda r: self.rank(r, now),
                          eligible=self.victim_eligible)


class FCFSPolicy(SchedulerPolicy):
    """vLLM default: first-come-first-served (+ chunked prefill in engine)."""
    name = "fcfs"

    def rank(self, req, now):
        return req.arrival


class EDFPolicy(SchedulerPolicy):
    """Earliest-deadline-first; aggressive deadline-driven preemption."""
    name = "edf"

    def rank(self, req, now):
        return req.arrival + req.slo


class StaticPriorityPolicy(SchedulerPolicy):
    """Motorcycles -> cars -> trucks, FCFS within class (paper §3.4 study)."""
    name = "static"

    def rank(self, req, now):
        return (CLASS_RANK[req.vclass], req.arrival)


class NaiveAgingPolicy(SchedulerPolicy):
    """Priority purely by age, ignoring the class hierarchy (ablation)."""
    name = "naive-aging"

    def rank(self, req, now):
        return req.enqueue_time

    def make_waiting_index(self):
        # Within a class, enqueue order IS rank order; across classes only
        # the heads need comparing. (Tie order matches the seed's stable
        # sort: class enum order, then FIFO position.)
        return WaitingIndex(
            within_key=lambda r, seq: (r.enqueue_time, seq),
            head_key=lambda r, now: r.enqueue_time)


@dataclass
class TCMPolicy(SchedulerPolicy):
    """Full TCM-Serve: dynamic priority = static class priority + aging.

    Scores are recomputed every scheduling iteration (the Priority
    Regulator 'continuously revisits priorities') — but only for the three
    class-queue heads: within a class the score is monotone in waiting
    time, so (enqueue_time, arrival) order is score order and never needs
    re-sorting. Motorcycles are never preempted (paper Fig. 11 shows zero
    motorcycle preemptions).
    """
    regulator: PriorityRegulator = field(default_factory=PriorityRegulator)
    name = "tcm"

    def rank(self, req, now):
        return (self.regulator.request_score(req, now), req.arrival)

    def victim_eligible(self, req):
        return req.vclass is not VehicleClass.MOTORCYCLE

    def make_waiting_index(self):
        reg = self.regulator
        # terminal score per class: the aging term rounds to exactly 1.0 at
        # large waits, so the score bottoms out at -log(static + 1) and the
        # seed's sort starts breaking those ties by arrival (see
        # ordering.py on saturation); computed with the same float ops as
        # request_score for bit equality
        floors = {v: -math.log(max(reg.params[v]["static"] + 1.0, EPS))
                  for v in VehicleClass}
        return WaitingIndex(
            within_key=lambda r, seq: (r.enqueue_time, r.arrival, seq),
            head_key=lambda r, now: (reg.request_score(r, now), r.arrival),
            score_floor=floors)


def make_policy(name: str) -> SchedulerPolicy:
    return {
        "fcfs": FCFSPolicy,
        "edf": EDFPolicy,
        "static": StaticPriorityPolicy,
        "naive-aging": NaiveAgingPolicy,
        "tcm": TCMPolicy,
    }[name]()
