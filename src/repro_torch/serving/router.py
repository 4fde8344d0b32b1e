"""Multi-replica serving router (beyond-paper: the paper's §4.4 lists
multi-GPU/multi-node scaling as future work).

Each replica is a full TCM engine (own scheduler, KV allocator, executor).
The router assigns requests at arrival:

  * round-robin      — baseline.
  * least-loaded     — by outstanding estimated prefill seconds.
  * truck-isolation  — modality-aware placement: trucks (and spillover
    cars) are pinned to a dedicated subset of replicas so motorcycles get
    contention-free replicas — the scheduling-level analogue of ModServe's
    stage disaggregation, built on TCM's own classifier.
  * prefix-aware     — place where the replica's KV prefix cache already
    holds the longest match for the request's content (tie: least load),
    so duplicate rocks land where their pages are.
  * pressure-aware   — overload-control routing: prefer the
    replica lowest on its brownout ladder (see serving/admission.py),
    breaking ties by outstanding load — arrivals drain away from
    replicas that are browning out before their admission controllers
    start rejecting, the fleet-scale hook the ROADMAP's open item
    anticipates.

Failover: ``run_stepped`` co-simulates every replica
on one timeline, applies whole-replica crashes from the fault plan's
``replica_kills`` schedule, and re-dispatches each dead replica's
in-flight (and still-pending) requests to surviving replicas —
prefix-cache-aware, so re-dispatched work re-claims any pages a survivor
already holds for the same content. A crash loses the replica's memory
(KV, encoder cache, progress); requests restart from scratch via
``Request.reset_for_redispatch`` — none lost, none double-finished.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.scheduler import make_policy
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.request import Request, VehicleClass


@dataclass
class Router:
    executors: list            # one per replica
    classifier: object
    engine_cfg: EngineConfig
    policy: str = "tcm"        # per-replica scheduling policy
    routing: str = "least-loaded"
    truck_replicas: int = 1    # for truck-isolation: replicas reserved
    # fault plan shared by every replica (serving/faults.py) or None.
    # Replica kills only take effect under ``run_stepped``; per-request
    # faults key off rid/content so sharing one plan stays deterministic.
    faults: object | None = None

    def __post_init__(self):
        self.engines = [Engine(make_policy(self.policy), ex, self.classifier,
                               self.engine_cfg, faults=self.faults)
                        for ex in self.executors]
        self._rr = 0
        self._load = [0.0] * len(self.engines)
        # health tracking + failover accounting
        self.alive = [True] * len(self.engines)
        self.killed_at: list[float | None] = [None] * len(self.engines)
        self._assigned: list[list[Request]] = [[] for _ in self.engines]
        self.kill_events: list[dict] = []
        self.redispatched = 0
        self.lost: list[Request] = []

    # ------------------------------------------------------------------
    def _route(self, req: Request) -> int:
        n = len(self.engines)
        if self.routing == "round-robin":
            # return the current cursor, THEN advance — incrementing first
            # skipped replica 0 on the first assignment and started every
            # run load-skewed
            i = self._rr
            self._rr = (self._rr + 1) % n
            return i
        vclass, est_prefill, _ = self.classifier.classify(
            req.modality.value, req.text_tokens, req.mm_units)
        if self.routing == "least-loaded":
            i = min(range(n), key=lambda j: self._load[j])
            self._load[i] += est_prefill
            return i
        if self.routing == "truck-isolation":
            heavy = set(range(n - self.truck_replicas, n))
            light = [j for j in range(n) if j not in heavy]
            if vclass is VehicleClass.TRUCK:
                pool = sorted(heavy)
            elif vclass is VehicleClass.CAR:
                pool = light + sorted(heavy)   # cars spill to heavy replicas
            else:
                pool = light
            i = min(pool, key=lambda j: self._load[j])
            self._load[i] += est_prefill
            return i
        if self.routing == "prefix-aware":
            i = self._prefix_target(req)
            self._load[i] += est_prefill
            return i
        if self.routing == "pressure-aware":
            pool = [j for j in range(n) if self.alive[j]] or list(range(n))
            i = min(pool, key=lambda j: (
                self.engines[j].ladder.level
                if self.engines[j].ladder is not None else 0,
                self._load[j]))
            self._load[i] += est_prefill
            return i
        raise ValueError(self.routing)

    def _redispatch_pool(self) -> list[int]:
        """Replicas eligible to receive re-dispatched/migrated work.
        The base router accepts any alive replica; the fleet tier
        (serving/fleet.py) also excludes draining ones."""
        return [j for j in range(len(self.engines)) if self.alive[j]]

    def _prefix_target(self, req: Request) -> int:
        """Eligible replica whose KV prefix cache matches the most tokens
        of this request's content (ties break toward the least-loaded)."""
        pool = self._redispatch_pool()
        limit = max(req.prompt_tokens - 1, 0)
        return max(pool, key=lambda j: (
            self.engines[j].allocator.match_prefix(
                req.content_chunks(), limit).tokens,
            -self._load[j]))

    # ------------------------------------------------------------------
    def run(self, requests: list[Request]) -> list[Request]:
        buckets: list[list[Request]] = [[] for _ in self.engines]
        for req in sorted(requests, key=lambda r: r.arrival):
            buckets[self._route(req)].append(req)
        done: list[Request] = []
        for eng, bucket in zip(self.engines, buckets):
            done.extend(eng.run(bucket))
        return done

    # -- failover co-simulation ------------------------------
    def _kill(self, i: int, remaining: list[list[Request]]) -> None:
        """Replica crash: its memory (KV, encoder cache, all request
        progress) is gone. Every non-terminal request assigned to it —
        in-flight or still pending — restarts from scratch on the best
        surviving replica (prefix-aware: a survivor may already hold
        pages for the same content)."""
        eng = self.engines[i]
        self.alive[i] = False
        self.killed_at[i] = eng.now
        inflight = [r for r in self._assigned[i] if not r.is_terminal]
        self._assigned[i] = [r for r in self._assigned[i] if r.is_terminal]
        remaining[i] = []
        moved = 0
        for req in inflight:
            # release the dead engine's side of the request exactly once
            # (queue slots, KV pages, encoder-cache pins, executor memos)
            # BEFORE resetting it — a crashed replica's caches must audit
            # clean (zero pins, zero used pages), and ENCODING requests
            # otherwise leaked their encoder pin forever
            eng.export_request(req)
            req.reset_for_redispatch()
            if not any(self.alive):
                self.lost.append(req)
                continue
            j = self._prefix_target(req)
            self._load[j] += req.est_prefill
            remaining[j].append(req)
            self._assigned[j].append(req)
            moved += 1
        for lst in remaining:
            lst.sort(key=lambda r: r.arrival)
        self.redispatched += moved
        self.kill_events.append(
            {"replica": i, "time": eng.now, "redispatched": moved})

    # -- stepped co-simulation hooks (overridden by serving/fleet.py) --
    def _dispatch_arrivals(self, reqs_sorted: list[Request],
                           remaining: list[list[Request]]) -> list[Request]:
        """Route the (arrival-sorted) workload into per-replica pending
        lists. The base router routes everything up-front and keeps no
        deferred pool; the fleet tier defers routing to arrival time so
        elastic repartitions can steer traffic mid-run. Returns the
        not-yet-routed tail (always empty here)."""
        for req in reqs_sorted:
            i = self._route(req)
            remaining[i].append(req)
            self._assigned[i].append(req)
        return []

    def _fleet_tick(self, pending: list[Request],
                    remaining: list[list[Request]]) -> list[Request]:
        """Per-outer-step fleet-tier hook (deferred routing, drains,
        health scoring, elastic repartitioning). No-op in the base
        router — which is exactly what keeps the fleet tier's
        no-events timeline bit-identical to this one."""
        return pending

    def _revivable(self) -> bool:
        """Whether a fully-idle/dead fleet can still come back (armed
        restarts, fleet tier). The base router's replicas never return,
        so an empty live set always ends the run."""
        return False

    def _next_arrival(self, i: int, pending: list[Request],
                      remaining: list[list[Request]]) -> float | None:
        """Earliest arrival that could still reach replica ``i`` (the
        idle-victim kill check must not let an idle clock jump a
        scheduled crash). The fleet tier also counts unrouted pending
        arrivals, any of which might route here."""
        return remaining[i][0].arrival if remaining[i] else None

    def run_stepped(self, requests: list[Request],
                    max_steps: int = 2_000_000) -> list[Request]:
        """Co-simulate all replicas step-by-step on one timeline: each
        outer step advances the alive replica whose clock lags furthest
        behind, and replica kills scheduled in the fault plan fire when
        the victim's clock reaches the kill time (an idle victim whose
        next arrival lies past the kill time dies in place — its clock
        would otherwise jump the crash)."""
        n = len(self.engines)
        remaining: list[list[Request]] = [[] for _ in range(n)]
        pending = self._dispatch_arrivals(
            sorted(requests, key=lambda r: r.arrival), remaining)
        for _ in range(max_steps):
            pending = self._fleet_tick(pending, remaining)
            if self.faults is not None:
                for i, eng in enumerate(self.engines):
                    if not self.alive[i]:
                        continue
                    if self.killed_at[i] is not None:
                        # already died once and was restarted (fleet tier):
                        # the kill schedule must not re-fire on
                        # the fresh engine. No-op for the base router
                        # (alive stays False after a kill).
                        continue
                    kt = self.faults.kill_time(i)
                    if kt is None:
                        continue
                    nxt = self._next_arrival(i, pending, remaining)
                    if eng.now >= kt or (eng.idle and
                                         (nxt is None or nxt > kt)):
                        self._kill(i, remaining)
            live = [i for i in range(n) if self.alive[i]
                    and (not self.engines[i].idle or remaining[i])]
            if not live:
                if self._revivable():
                    # armed restarts (fleet tier): the next _fleet_tick
                    # fires them by jumping to their scheduled time
                    continue
                break
            i = min(live, key=lambda j: self.engines[j].now)
            remaining[i] = self.engines[i].step(remaining[i])
        return [r for eng in self.engines for r in eng.finished]
