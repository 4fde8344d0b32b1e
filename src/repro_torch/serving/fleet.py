"""Fleet tier: replica lifecycle, graceful drain, elastic repartitioning.

``Router`` (serving/router.py) treats replicas as permanently-identical
crash-only boxes: routing modes are static and the only lifecycle event is
a kill. Production fleets also *drain* replicas (rolling restarts,
scale-down), watch replica *health*, and re-shape modality partitions as
the arrival mix shifts (ElasticMM, PAPERS.md). ``Fleet`` layers all of
that on the same stepped co-simulation:

  * **lifecycle** — every replica is HEALTHY / DEGRADED / DRAINING / DEAD
    / RESTARTING. Health is scored each co-sim step from heartbeat-style
    signals off the stepped clock (brownout-ladder level, backlog depth,
    clock lag behind the fleet frontier) with a consecutive-observation
    hysteresis window, so one bad step never flaps a replica. A replica
    DEGRADED for ``auto_drain_window`` consecutive ticks starts its own
    graceful drain through the operator-drain path.
  * **crash recovery** — killed and drained replicas restart
    on a schedule (``FleetConfig.restarts``) or fault-plan injection
    (``restart_delays``): a fresh engine takes the slot, optionally
    warms its prefix trie from the healthiest peer over the page-chain
    protocol, and re-enters routing only after the warm-up gate. With
    ``EngineConfig.journal=True`` every kill/drain cross-checks the
    replica's lifecycle-journal replay against its live accounting
    bit-exactly, and crashed in-flight work is recovered from the
    journal's replayed stage map (serving/journal.py).
  * **graceful drain** — a scheduled drain stops admissions to the
    replica, lets RUNNING decodes finish in place, and *migrates*
    everything else off via the page-chain transfer protocol
    (serving/migration.py): prefilled KV moves, the target re-prefills
    only the residual. When the last decode completes the replica leaves
    the fleet cleanly (state DEAD, nothing lost, caches audit empty).
  * **elastic repartitioning** — routing mode ``"elastic"`` is
    truck-isolation with a *dynamic* heavy-group size: a sliding window
    of routed arrivals tracks the truck share of estimated prefill work,
    and when the desired heavy-group size disagrees with the current one
    persistently (hysteresis: N consecutive decisions + a dwell time) the
    partition moves one replica at a time. A replica leaving the heavy
    group has its queued trucks migrated to the remaining heavy replicas.

**Bit-exactness contract**: with no drains scheduled, no kills in the
fault plan, and an inherited routing mode, ``Fleet.run_stepped`` produces
the exact timeline of ``Router.run_stepped``. The fleet defers routing to
arrival time (so repartitions can steer traffic mid-run), but routes in
the same arrival order with the same ``_route`` state, and only ever
routes a request before the co-sim frontier reaches its arrival — each
engine still ingests each request at the same local clock, so per-replica
simulations are unchanged. The no-events identity is gated in
benchmarks/fleet_tolerance.py.
"""
from __future__ import annotations

import enum
from collections import deque
from dataclasses import dataclass, field

from repro_torch.core.scheduler import make_policy

from .engine import Engine
from .journal import replay, verify_engine
from .migration import MigrationConfig, migrate, warm_import
from .request import Request, VehicleClass
from .router import Router


class ReplicaState(str, enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"    # signals bad for >= health_window steps:
    #                          elastic routing steers new work away
    DRAINING = "draining"    # no admissions; decodes finishing; queued
    #                          work migrating off
    DEAD = "dead"            # crashed (kill) or drained to completion
    RESTARTING = "restarting"  # fresh engine in the slot, warming up:
    #                            not routable until the rejoin gate opens


@dataclass
class FleetConfig:
    """Fleet-tier knobs. The all-defaults config schedules nothing — the
    bit-exact configuration."""
    # operator schedule: replica index -> sim time to begin draining
    drains: dict = field(default_factory=dict)
    migration: MigrationConfig = field(default_factory=MigrationConfig)
    # -- elastic repartitioning ("elastic" routing mode) ----------------
    elastic_window: int = 32       # routed arrivals in the sliding window
    elastic_min_heavy: int = 1     # heavy-group size bounds
    elastic_max_heavy: int | None = None   # default: n_replicas - 1
    elastic_persist: int = 8       # consecutive decisions before a move
    elastic_dwell_s: float = 5.0   # min sim seconds between moves
    # -- health scoring -------------------------------------------------
    degraded_ladder_level: int = 2   # brownout level >= this is a signal
    degraded_backlog: int = 64       # non-terminal assigned reqs >= this
    degraded_lag_s: float = 30.0     # clock behind fleet frontier >= this
    health_window: int = 3           # consecutive observations to flip
    # -- crash recovery --------------------------------------
    # operator restart schedule: replica -> seconds after its death that
    # a fresh engine restarts in the slot (FaultPlan.restart_delays is
    # the injected equivalent; this map takes precedence). Empty = no
    # replica ever comes back, the behaviour without restarts.
    restarts: dict = field(default_factory=dict)
    restart_warmup_s: float = 5.0    # min RESTARTING dwell before rejoin
    restart_warm_pages: int = 0      # prefix-trie pages to import from
    #                                  the healthiest peer while warming
    #                                  (0 = rejoin cold)
    # auto-drain: a replica DEGRADED for this many consecutive health
    # ticks starts a graceful drain on its own (None = operator-only)
    auto_drain_window: int | None = None


@dataclass
class Fleet(Router):
    """A ``Router`` with replica lifecycle, drain, and elastic routing.
    All Router fields and routing modes apply; add ``routing="elastic"``
    and a ``FleetConfig`` to enable the fleet-only behaviors."""
    fleet: FleetConfig = field(default_factory=FleetConfig)

    def __post_init__(self):
        super().__post_init__()
        n = len(self.engines)
        self.replica_state = [ReplicaState.HEALTHY] * n
        # elastic partition: heavy group starts as the truck-isolation
        # suffix so "elastic" with a static mix behaves like the baseline
        self._heavy = set(range(n - self.truck_replicas, n))
        self._work_window: deque = deque(maxlen=self.fleet.elastic_window)
        self._persist = 0
        self._last_repartition = float("-inf")
        # drain bookkeeping
        self._drain_started: dict[int, float] = {}
        # health hysteresis: consecutive bad / good observations
        self._health_bad = [0] * n
        self._health_good = [0] * n
        # counters (surfaced via metrics.summarize_fleet)
        self.migrations_out = [0] * n
        self.migrations_in = [0] * n
        self.migrations_attempted = 0
        self.migrations_succeeded = 0
        self.migration_fallbacks = 0
        self.migration_noops = 0     # nothing prefilled: plain redispatch
        self.migration_retries = 0
        self.migrated_pages = 0
        self.deduped_pages = 0
        self.drain_events: list[dict] = []
        self.repartition_events: list[dict] = []
        self.health_events: list[dict] = []
        # crash recovery
        self._death_time: list[float | None] = [None] * n
        self._restart_at: list[float | None] = [None] * n
        self._rejoin_at: list[float | None] = [None] * n
        self._drain_cause: dict[int, str] = {}
        self._degraded_streak = [0] * n
        self.restart_events: list[dict] = []
        self.retired: list[tuple[int, object]] = []  # (replica, old engine)
        # in-flight work from the LAST live replica's crash while a
        # restart is armed: orphaned (held for the restarted slot), not
        # lost — the whole-fleet outage is transient
        self._orphans: list[Request] = []
        # journal-replay cross-checks (serving/journal.py): every kill /
        # drain completion verifies replayed accounting against the live
        # engine bit-exactly; mismatches are real bugs, surfaced here
        self.journal_checks = 0
        self.journal_mismatches: list[str] = []

    # -- eligibility ----------------------------------------------------
    def _eligible(self) -> list[int]:
        """Replicas that may receive new or re-dispatched work."""
        return [j for j in range(len(self.engines))
                if self.alive[j]
                and self.replica_state[j] not in (ReplicaState.DRAINING,
                                                  ReplicaState.RESTARTING)]

    def _redispatch_pool(self) -> list[int]:
        pool = self._eligible()
        if pool:
            return pool
        # last resort: a draining replica beats losing the request
        return [j for j in range(len(self.engines)) if self.alive[j]]

    # -- routing --------------------------------------------------------
    def _route(self, req: Request) -> int:
        if self.routing != "elastic":
            i = super()._route(req)
            if self.alive[i] and self.replica_state[i] not in (
                    ReplicaState.DRAINING, ReplicaState.RESTARTING):
                return i
            # inherited mode picked an ineligible replica (only possible
            # once fleet events have fired, so bit-exactness is intact):
            # fall through to the best eligible one. The inherited mode
            # already bumped ``_load[i]`` (round-robin never bumps) —
            # remove that bump or load silently drifts upward on dead /
            # draining replicas across a long run, skewing every later
            # least-loaded comparison against them after a restart
            est = 0.0
            if self.routing != "round-robin":
                _vc, est, _kv = self.classifier.classify(
                    req.modality.value, req.text_tokens, req.mm_units)
                self._load[i] -= est
            j = min(self._redispatch_pool(),
                    key=lambda k: self._load[k])
            self._load[j] += est if est > 0.0 else req.est_prefill
            return j
        vclass, est_prefill, _ = self.classifier.classify(
            req.modality.value, req.text_tokens, req.mm_units)
        self._note_arrival(vclass, est_prefill)
        pool = self._redispatch_pool()
        healthy = [j for j in pool
                   if self.replica_state[j] is ReplicaState.HEALTHY]
        pool = healthy or pool
        heavy = [j for j in pool if j in self._heavy]
        light = [j for j in pool if j not in self._heavy]
        if vclass is VehicleClass.TRUCK:
            cand = heavy or pool
        elif vclass is VehicleClass.CAR:
            cand = (light + heavy) or pool
        else:
            cand = light or pool
        i = min(cand, key=lambda j: self._load[j])
        self._load[i] += est_prefill
        return i

    def _note_arrival(self, vclass, est_prefill: float) -> None:
        self._work_window.append(
            (est_prefill, vclass is VehicleClass.TRUCK))

    def _desired_heavy(self) -> int | None:
        if len(self._work_window) < self._work_window.maxlen:
            return None              # window not yet representative
        total = sum(w for w, _t in self._work_window)
        if total <= 0:
            return None
        frac = sum(w for w, t in self._work_window if t) / total
        n = len(self._eligible())
        lo = self.fleet.elastic_min_heavy
        hi = self.fleet.elastic_max_heavy
        if hi is None:
            hi = max(lo, n - 1)
        return max(lo, min(hi, round(frac * n)))

    def _maybe_repartition(self, remaining, clk: float) -> None:
        """One hysteresis-gated partition move: grow or shrink the heavy
        group by a single replica, migrating queued trucks off a replica
        that leaves it."""
        cur = len([j for j in self._eligible() if j in self._heavy])
        want = self._desired_heavy()
        if want is None or want == cur:
            self._persist = 0
            return
        self._persist += 1
        if self._persist < self.fleet.elastic_persist or \
                clk - self._last_repartition < self.fleet.elastic_dwell_s:
            return
        self._persist = 0
        self._last_repartition = clk
        eligible = self._eligible()
        if want > cur:
            # promote the least-loaded light replica
            light = [j for j in eligible if j not in self._heavy]
            if not light:
                return
            j = min(light, key=lambda k: self._load[k])
            self._heavy.add(j)
            moved = 0
        else:
            # demote the least-loaded heavy replica and move its queued
            # trucks to the replicas staying heavy
            heavy = [j for j in eligible if j in self._heavy]
            if len(heavy) <= 1:
                return
            j = min(heavy, key=lambda k: self._load[k])
            self._heavy.discard(j)
            moved = self._migrate_queued_trucks(j, remaining)
        self.repartition_events.append({
            "time": clk, "replica": j,
            "direction": "grow" if want > cur else "shrink",
            "heavy": sorted(self._heavy & set(self._eligible())),
            "migrated": moved})

    def _migrate_queued_trucks(self, i: int, remaining) -> int:
        """Move queued (not yet decoding) trucks off replica ``i`` after
        it left the heavy group."""
        eng = self.engines[i]
        moved = 0
        for req in list(self._assigned[i]):
            if req.is_terminal or req.vclass is not VehicleClass.TRUCK:
                continue
            if req.state.value == "running":
                continue             # decodes finish in place
            self._move_request(i, req, remaining, eng.now)
            moved += 1
        return moved

    # -- migration ------------------------------------------------------
    def _move_request(self, i: int, req: Request, remaining,
                      start: float) -> None:
        """Migrate one non-terminal request off replica ``i`` via the
        page-chain protocol, falling back to plain re-dispatch (full
        re-prefill on the target) when the transfer degrades."""
        if req in remaining[i]:
            # routed but never ingested: nothing on replica i to move
            remaining[i].remove(req)
            self._assigned[i].remove(req)
            j = self._prefix_target(req)
            self._place(j, req, remaining)
            return
        self._assigned[i].remove(req)
        j = self._prefix_target(req)
        plan = self.faults
        self.migrations_attempted += 1
        res = migrate(
            self.engines[i], self.engines[j], req, start,
            self.fleet.migration, plan,
            src_kill=plan.kill_time(i) if plan else None,
            dst_kill=plan.kill_time(j) if plan else None)
        self.migration_retries += res.retries
        self.migrated_pages += res.pages_imported
        self.deduped_pages += res.pages_deduped
        if res.status == "aborted_target_dead":
            # nothing landed on j (it is about to crash): send the
            # request to the next-best replica instead, plain re-prefill
            self.migration_fallbacks += 1
            pool = [k for k in self._redispatch_pool() if k != j] or \
                self._redispatch_pool()
            j = max(pool, key=lambda k: (
                self.engines[k].allocator.match_prefix(
                    req.content_chunks(),
                    max(req.prompt_tokens - 1, 0)).tokens,
                -self._load[k]))
        elif res.status == "migrated":
            self.migrations_succeeded += 1
        elif res.status == "fallback" and res.chunks_sent == 0:
            # empty manifest — the request had no transferable pages yet
            # (still queued / barely prefilled): a plain re-dispatch, not
            # a protocol degradation
            self.migration_noops += 1
        else:
            self.migration_fallbacks += 1
        self.migrations_out[i] += 1
        self.migrations_in[j] += 1
        self._place(j, req, remaining)

    def _place(self, j: int, req: Request, remaining) -> None:
        self._load[j] += req.est_prefill
        remaining[j].append(req)
        remaining[j].sort(key=lambda r: r.arrival)
        self._assigned[j].append(req)

    # -- drains ---------------------------------------------------------
    def _start_drain(self, i: int, remaining, when: float,
                     cause: str = "operator") -> None:
        """One drain path for operator schedules and health-driven auto
        drains: only the ``cause`` tag differs."""
        self.replica_state[i] = ReplicaState.DRAINING
        self._drain_started[i] = when
        self._drain_cause[i] = cause
        eng = self.engines[i]
        moved = 0
        for req in list(self._assigned[i]):
            if req.is_terminal:
                continue
            if req.state.value == "running":
                continue             # decodes finish in place
            self._move_request(i, req, remaining, max(eng.now, when))
            moved += 1
        self.health_events.append(
            {"time": when, "replica": i, "state": "draining",
             "cause": cause})
        self._drain_moved = getattr(self, "_drain_moved", {})
        self._drain_moved[i] = moved

    def _finish_drain(self, i: int, remaining) -> None:
        eng = self.engines[i]
        self.alive[i] = False
        self.replica_state[i] = ReplicaState.DEAD
        start = self._drain_started[i]
        self.drain_events.append({
            "replica": i, "start": start, "end": eng.now,
            "duration": max(0.0, eng.now - start),
            "cause": self._drain_cause.get(i, "operator"),
            "migrated": getattr(self, "_drain_moved", {}).get(i, 0)})
        # a drained replica left cleanly: its journal replay must agree
        # with the (now empty) live accounting bit-exactly
        self._verify_journal(i, eng)
        self._death_time[i] = eng.now
        self._schedule_restart(i)

    def _tick_drains(self, pending, remaining, clk) -> None:
        # start loop: operator-scheduled drains only (auto drains start
        # from the health tick); each schedule entry fires at most once —
        # a replica that drained, restarted, and rejoined must not
        # re-drain off the same stale entry
        for i, t in self.fleet.drains.items():
            eng = self.engines[i]
            if not self.alive[i] or i in self._drain_started or \
                    self.replica_state[i] not in (ReplicaState.HEALTHY,
                                                  ReplicaState.DEGRADED):
                continue
            nxt = self._next_arrival(i, pending, remaining)
            if eng.now >= t or (clk is not None and clk >= t) or \
                    (eng.idle and (nxt is None or nxt > t)):
                self._start_drain(i, remaining, max(eng.now, t))
        # completion loop: every DRAINING replica, whatever started it.
        # Checked in the same tick a drain starts: a replica drained
        # while already idle leaves the fleet now, not on a later tick
        # that may never come
        for i, eng in enumerate(self.engines):
            if self.alive[i] and \
                    self.replica_state[i] is ReplicaState.DRAINING and \
                    eng.idle and not remaining[i] and all(
                        r.is_terminal for r in self._assigned[i]):
                self._finish_drain(i, remaining)

    # -- health ---------------------------------------------------------
    def _tick_health(self, remaining) -> None:
        cfg = self.fleet
        frontier = max((e.now for e, a in zip(self.engines, self.alive)
                        if a), default=0.0)
        for i, eng in enumerate(self.engines):
            st = self.replica_state[i]
            if st in (ReplicaState.DRAINING, ReplicaState.DEAD,
                      ReplicaState.RESTARTING):
                continue
            backlog = (len(remaining[i]) + len(eng.queues) +
                       len(eng.encode_queues) + len(eng.prefilling) +
                       len(eng.running))
            bad = (
                (eng.ladder is not None and
                 eng.ladder.level >= cfg.degraded_ladder_level)
                or backlog >= cfg.degraded_backlog
                or (backlog > 0 and
                    frontier - eng.now >= cfg.degraded_lag_s))
            if bad:
                self._health_bad[i] += 1
                self._health_good[i] = 0
            else:
                self._health_good[i] += 1
                self._health_bad[i] = 0
            if st is ReplicaState.HEALTHY and \
                    self._health_bad[i] >= cfg.health_window:
                self.replica_state[i] = ReplicaState.DEGRADED
                self.health_events.append(
                    {"time": eng.now, "replica": i, "state": "degraded"})
            elif st is ReplicaState.DEGRADED and \
                    self._health_good[i] >= cfg.health_window:
                self.replica_state[i] = ReplicaState.HEALTHY
                self.health_events.append(
                    {"time": eng.now, "replica": i, "state": "healthy"})
            # health-scored auto-drain: persistently DEGRADED
            # replicas initiate their own graceful drain through the
            # same path an operator schedule uses
            if self.replica_state[i] is ReplicaState.DEGRADED:
                self._degraded_streak[i] += 1
                if cfg.auto_drain_window is not None and \
                        self._degraded_streak[i] >= cfg.auto_drain_window:
                    self._degraded_streak[i] = 0
                    self._start_drain(i, remaining, eng.now, cause="auto")
            else:
                self._degraded_streak[i] = 0

    # -- journal cross-checks ---------------------------------
    def _verify_journal(self, i: int, eng) -> None:
        """Replay the replica's journal and compare against its live
        accounting bit-exactly; record any divergence (a real bug in
        either derivation, never tolerated)."""
        if eng.journal is None:
            return
        self.journal_checks += 1
        for m in verify_engine(eng):
            self.journal_mismatches.append(f"replica {i}: {m}")

    def verify_journals(self) -> list[str]:
        """End-of-run sweep: replay-verify every engine that ever served
        — current slots and retired (pre-restart) engines alike. Returns
        the accumulated mismatch list (empty = every journal agrees with
        its live accounting bit-exactly)."""
        for i, eng in enumerate(self.engines):
            self._verify_journal(i, eng)
        for i, eng in self.retired:
            self._verify_journal(i, eng)
        return self.journal_mismatches

    # -- kill override ---------------------------------------------------
    def _kill(self, i: int, remaining) -> None:
        eng = self.engines[i]
        recovered_stages = None
        if eng.journal is not None:
            # crash recovery from the journal: the replayed in-flight set
            # (ingested here, not terminal, not exported) is exactly what
            # the dead replica still owed — cross-checked against the
            # live-state derivation the redispatch below acts on
            st = replay(eng.journal.records)
            jset = st.inflight
            rem_rids = {r.rid for r in remaining[i]}
            live = {r.rid for r in self._assigned[i]
                    if not r.is_terminal and r.rid not in rem_rids}
            if jset != live:
                self.journal_mismatches.append(
                    f"replica {i}: crash-recovery set: journal-only "
                    f"{sorted(jset - live)} live-only {sorted(live - jset)}")
            recovered_stages = {}
            for rid in jset:
                s = st.stage.get(rid, "?")
                recovered_stages[s] = recovered_stages.get(s, 0) + 1
        self.replica_state[i] = ReplicaState.DEAD
        pre_lost = len(self.lost)
        super()._kill(i, remaining)
        if recovered_stages is not None:
            # known stage at crash, straight from the journal (the kill
            # event's operator-facing recovery manifest)
            self.kill_events[-1]["recovered_stages"] = recovered_stages
        # post-export the dead engine must audit clean — journal replay
        # included (every recovered request shows release+export)
        self._verify_journal(i, eng)
        self._death_time[i] = eng.now
        self._schedule_restart(i)
        if len(self.lost) > pre_lost and self._restarts_armed():
            # the last live replica died with a restart armed somewhere:
            # its in-flight is orphaned, not lost — redispatched when a
            # slot rejoins (_tick_restarts)
            self._orphans.extend(self.lost[pre_lost:])
            del self.lost[pre_lost:]

    # -- restart & rejoin --------------------------------------
    def _schedule_restart(self, i: int) -> None:
        """Arm a restart for a replica that just died (kill or drain):
        the fleet schedule takes precedence, then the fault plan's
        injected delay; neither = the slot stays down forever."""
        delay = self.fleet.restarts.get(i)
        if delay is None and self.faults is not None:
            delay = self.faults.restart_delay(i)
        if delay is not None:
            self._restart_at[i] = self._death_time[i] + delay

    def _warm_source(self, i: int) -> int | None:
        """Healthiest peer to warm replica ``i``'s prefix trie from:
        prefer HEALTHY over DEGRADED, then the largest cached trie."""
        cands = [j for j in range(len(self.engines))
                 if j != i and self.alive[j]
                 and self.replica_state[j] in (ReplicaState.HEALTHY,
                                               ReplicaState.DEGRADED)]
        if not cands:
            return None
        return max(cands, key=lambda j: (
            self.replica_state[j] is ReplicaState.HEALTHY,
            self.engines[j].allocator.cached_pages, -j))

    def _do_restart(self, i: int, at: float) -> None:
        """A fresh engine takes the dead replica's slot: cold allocator,
        cold caches, fresh journal, zeroed executor state — everything
        the old process held is gone (it was exported/verified at death).
        Optionally warms its prefix trie from the healthiest peer over
        the page-chain transfer protocol; re-enters routing only when
        the warm-up gate opens (``_rejoin_at``)."""
        old_ex = self.executors[i]
        ex = old_ex.fresh() if hasattr(old_ex, "fresh") else old_ex
        self.executors[i] = ex
        self.retired.append((i, self.engines[i]))
        eng = Engine(make_policy(self.policy), ex, self.classifier,
                     self.engine_cfg, faults=self.faults)
        eng.now = at
        self.engines[i] = eng
        self.alive[i] = True
        self.replica_state[i] = ReplicaState.RESTARTING
        self._restart_at[i] = None
        self._load[i] = 0.0
        self._health_bad[i] = self._health_good[i] = 0
        self._degraded_streak[i] = 0
        ready = at + self.fleet.restart_warmup_s
        src = None
        warm_imported = warm_deduped = 0
        if self.fleet.restart_warm_pages > 0:
            src = self._warm_source(i)
            if src is not None:
                res = warm_import(self.engines[src], eng, at,
                                  self.fleet.migration, self.faults,
                                  self.fleet.restart_warm_pages)
                warm_imported = res.pages_imported
                warm_deduped = res.pages_deduped
                self.migrated_pages += res.pages_imported
                self.deduped_pages += res.pages_deduped
                self.migration_retries += res.retries
                ready = max(ready, res.finish_time)
        self._rejoin_at[i] = ready
        self.restart_events.append({
            "replica": i, "died": self._death_time[i], "restarted": at,
            "rejoin_at": ready, "warm_source": src,
            "warm_pages_imported": warm_imported,
            "warm_pages_deduped": warm_deduped})

    def _tick_restarts(self, pending, remaining, clk) -> None:
        """Fire armed restarts the co-sim frontier has reached and open
        rejoin gates for warmed-up RESTARTING replicas. With no live
        clock (fleet idle or fully dead) a pending restart fires by
        jumping to its scheduled time — the co-sim analogue of the
        idle-jump, and what keeps a whole-fleet outage with a scheduled
        restart from losing the tail of the workload."""
        for i in range(len(self.engines)):
            at = self._restart_at[i]
            if at is not None and (clk is None or clk >= at):
                self._do_restart(i, at)
        for i in range(len(self.engines)):
            ra = self._rejoin_at[i]
            if ra is None or \
                    self.replica_state[i] is not ReplicaState.RESTARTING:
                continue
            eng = self.engines[i]
            ref = max(clk, eng.now) if clk is not None else eng.now
            if clk is None or ref >= ra:
                self._rejoin_at[i] = None
                self.replica_state[i] = ReplicaState.HEALTHY
                self.health_events.append(
                    {"time": max(ref, ra), "replica": i,
                     "state": "rejoined"})
        if self._orphans and self._eligible():
            # a slot rejoined after a whole-fleet outage: the crash's
            # orphaned in-flight (already reset for redispatch) lands on
            # the best eligible replica, prefix-aware like any failover
            orphans, self._orphans = self._orphans, []
            for req in orphans:
                j = self._prefix_target(req)
                self._load[j] += req.est_prefill
                remaining[j].append(req)
                self._assigned[j].append(req)
                self.redispatched += 1
            for lst in remaining:
                lst.sort(key=lambda r: r.arrival)

    def _restarts_armed(self) -> bool:
        return any(at is not None for at in self._restart_at) or \
            ReplicaState.RESTARTING in self.replica_state

    def _revivable(self) -> bool:
        return self._restarts_armed()

    # -- stepped co-sim hooks --------------------------------------------
    def _live_clock(self, remaining) -> float | None:
        live = [j for j in range(len(self.engines)) if self.alive[j]
                and (not self.engines[j].idle or remaining[j])]
        if not live:
            return None
        return min(self.engines[j].now for j in live)

    def _next_arrival(self, i, pending, remaining):
        nxt = super()._next_arrival(i, pending, remaining)
        if pending:
            p = pending[0].arrival
            nxt = p if nxt is None else min(nxt, p)
        return nxt

    def _dispatch_arrivals(self, reqs_sorted, remaining):
        # defer routing to arrival time: elastic repartitions (and
        # drains/health) must be able to steer traffic mid-run
        return list(reqs_sorted)

    def _fleet_tick(self, pending, remaining):
        clk = self._live_clock(remaining)
        if self._restarts_armed():
            self._tick_restarts(pending, remaining, clk)
            clk = self._live_clock(remaining)
        if self.fleet.drains or ReplicaState.DRAINING in self.replica_state:
            self._tick_drains(pending, remaining, clk)
            clk = self._live_clock(remaining)
        self._tick_health(remaining)
        # route every arrival the co-sim frontier has reached; the clock
        # is recomputed per route because routing to a lagging idle
        # replica can pull the frontier back
        while pending:
            clk = self._live_clock(remaining)
            if clk is None:
                break                # no live engine: force-route below
            if pending[0].arrival > clk:
                break
            self._admit(pending.pop(0), remaining, clk)
        if pending and self._live_clock(remaining) is None:
            if not any(self.alive):
                # whole fleet is down — but a scheduled restart means the
                # outage is transient: jump to it instead of losing the
                # tail of the workload
                if self._restarts_armed():
                    self._tick_restarts(pending, remaining, None)
                if not any(self.alive):
                    self.lost.extend(pending)   # fleet gone for good
                    return []
            # fleet fully idle: route the next arrival so the co-sim can
            # jump to it (mirrors the base router's idle-jump semantics)
            req = pending.pop(0)
            self._admit(req, remaining, req.arrival)
        return pending

    def _admit(self, req: Request, remaining, clk: float) -> None:
        i = self._route(req)
        remaining[i].append(req)
        self._assigned[i].append(req)
        if self.routing == "elastic":
            self._maybe_repartition(remaining, max(clk, req.arrival))

    def run_stepped(self, requests: list[Request],
                    max_steps: int = 2_000_000) -> list[Request]:
        done = super().run_stepped(requests, max_steps)
        # requests that finished on a retired engine (before its slot
        # restarted) are completions too — the current engines' lists
        # alone under-report them
        seen = {r.rid for r in done}
        done.extend(r for _i, eng in self.retired for r in eng.finished
                    if r.rid not in seen)
        return done
