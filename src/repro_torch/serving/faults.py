"""Deterministic fault injection for the serving tier.

Production MLLM traffic is not fault-free: clients disconnect mid-stream,
encoders hit corrupt frames, executor steps fail transiently, deadlines
expire, and whole replicas die (ServeGen/ElasticMM, PAPERS.md). The engine
and router expose named injection points; a ``FaultPlan`` decides — purely
from a seed and per-request content — what fails where, so every chaos
scenario replays bit-identically: a failing schedule from a CI log is a
regression test, never a flake.

Injection points (the engine/router query these; ``None`` plan = no-op):

  * ``should_cancel(req, stage)`` — client cancellation/disconnect, fired
    the *n*-th time the engine observes the request in the sampled stage
    (waiting / encoding / prefilling / running / preempted — including
    mid-COW-claim and post-preemption windows).
  * ``deadline_for(req)`` — per-request hard deadline, seconds after
    arrival; the engine aborts expired requests exactly once.
  * ``encoder_fault(req)`` — this encode chunk fails; the engine retries
    with backoff up to ``EngineConfig.max_encode_retries``, then fails the
    request terminally.
  * ``step_fault(iteration, attempt)`` — transient executor-step fault;
    the engine retries the iteration with backoff up to
    ``EngineConfig.max_step_retries``, then fails the batch.
  * ``kill_time(replica)`` — whole-replica crash for the router's stepped
    co-simulation; in-flight requests are re-dispatched prefix-cache-aware
    to surviving replicas.
  * ``migration_fault(rid, chunk, attempt)`` — migration-domain faults:
    one bounded chunk of a page-chain transfer times out or
    arrives corrupted (checksum verification fails); the migrator retries
    with backoff, then falls back to residual re-prefill on the target.
    Source/target-dies-mid-transfer are not sampled here — they emerge
    when ``kill_time`` intersects the transfer window (serving/migration.py
    cuts the transfer off at the crash).

Determinism contract: per-request decisions are hashed from
``(seed, kind, rid)`` — independent of arrival order, scheduling, or how
many other requests exist — and per-iteration decisions from
``(seed, iteration)``. A plan is *stateful for one run* (it counts stage
observations and encode attempts); build a fresh plan with the same seed
to replay the identical schedule.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field

import numpy as np


class FaultError(RuntimeError):
    """Base class for injected / lifecycle faults."""


class CapacityExceeded(FaultError):
    """A request's context can never fit total KV capacity — retrying
    (self-preemption + re-admission) would livelock, so the engine fails
    the request terminally instead."""


class EncoderFault(FaultError):
    """Injected vision-encoder chunk failure (corrupt frame, OOM, ...)."""


class ExecutorFault(FaultError):
    """Injected executor step failure (transient unless retries exhaust)."""


#: stages a sampled cancellation can target (State values the engine
#: observes at its transition checkpoints)
CANCEL_STAGES = ("waiting", "encoding", "prefilling", "running", "preempted")


@dataclass
class FaultRates:
    """Sampling knobs for ``FaultPlan.sample`` — probabilities are
    per-request (cancel/deadline/encoder) or per-iteration (step)."""
    cancel_prob: float = 0.0
    deadline_prob: float = 0.0
    encoder_fault_prob: float = 0.0
    step_fault_prob: float = 0.0
    # migration-domain: per-chunk probabilities that one bounded
    # chunk of a page-chain transfer times out / fails checksum verify
    migration_timeout_prob: float = 0.0
    migration_corrupt_prob: float = 0.0
    # a faulted request/iteration is *permanent* (outlasts every retry)
    # with this probability; otherwise it heals after 1-2 retries
    permanent_frac: float = 0.15
    # sampled deadlines: uniform seconds after arrival (tight enough that
    # some expire under load, loose enough that most do not)
    deadline_min_s: float = 2.0
    deadline_max_s: float = 60.0

    def scaled(self, f: float) -> "FaultRates":
        """The same shape of chaos at ``f``x the event rates (escalation
        schedule of benchmarks/fault_tolerance.py)."""
        return FaultRates(
            cancel_prob=min(1.0, self.cancel_prob * f),
            deadline_prob=min(1.0, self.deadline_prob * f),
            encoder_fault_prob=min(1.0, self.encoder_fault_prob * f),
            step_fault_prob=min(1.0, self.step_fault_prob * f),
            migration_timeout_prob=min(1.0, self.migration_timeout_prob * f),
            migration_corrupt_prob=min(1.0, self.migration_corrupt_prob * f),
            permanent_frac=self.permanent_frac,
            deadline_min_s=self.deadline_min_s,
            deadline_max_s=self.deadline_max_s)


# a retry count no schedule reaches: "permanent" faults fail every attempt
_PERMANENT = 1 << 20


@dataclass
class FaultPlan:
    """One run's fault schedule. Explicit injections (the ``cancels`` /
    ``deadlines`` / ``encoder_faults`` / ``step_faults`` /
    ``replica_kills`` maps) take precedence; anything not pinned
    explicitly is sampled from ``rates`` (all-zero by default, so
    ``FaultPlan()`` is the installed-but-inert layer used for the
    fault-free-parity gates)."""
    seed: int = 0
    rates: FaultRates = field(default_factory=FaultRates)
    # explicit injections -------------------------------------------------
    cancels: dict = field(default_factory=dict)        # rid -> (stage, nth)
    deadlines: dict = field(default_factory=dict)      # rid -> rel seconds
    encoder_faults: dict = field(default_factory=dict)  # rid -> n failures
    step_faults: dict = field(default_factory=dict)    # iter -> n failures
    replica_kills: dict = field(default_factory=dict)  # replica -> time
    # (rid, chunk) -> ("timeout"|"corrupt", n attempts it outlasts)
    migration_faults: dict = field(default_factory=dict)
    # crash recovery: replica -> seconds after its death that
    # a fresh engine restarts in its slot (rejoin is further gated by the
    # fleet's warm-up window). Absent replicas stay down forever — the
    # behaviour without restarts, and the bit-exact default.
    restart_delays: dict = field(default_factory=dict)

    def __post_init__(self):
        # run-scoped observation state (see module docstring)
        self._stage_seen: dict[tuple[str, str], int] = {}
        self._encode_attempts: dict[str, int] = {}
        self._cancel_memo: dict[str, tuple | None] = {}
        self._deadline_memo: dict[str, float | None] = {}
        self._encoder_memo: dict[str, int] = {}
        self._step_memo: dict[int, int] = {}
        self._migration_memo: dict[tuple, tuple] = {}
        # counters (surfaced by the chaos benchmark)
        self.injected = {"cancel": 0, "deadline": 0, "encoder": 0,
                         "step": 0, "mig_timeout": 0, "mig_corrupt": 0}

    # -- deterministic per-key RNG ----------------------------------------
    def _rng(self, kind: str, key) -> np.random.Generator:
        h = zlib.crc32(f"{self.seed}:{kind}:{key}".encode()) & 0x7FFFFFFF
        return np.random.default_rng(h)

    def _severity(self, rng: np.random.Generator) -> int:
        """How many attempts a sampled fault outlasts."""
        if rng.uniform() < self.rates.permanent_frac:
            return _PERMANENT
        return int(rng.integers(1, 3))

    # -- cancellation ------------------------------------------------------
    def _cancel_point(self, rid: str) -> tuple | None:
        if rid in self._cancel_memo:
            return self._cancel_memo[rid]
        point = self.cancels.get(rid)
        if point is None and self.rates.cancel_prob > 0:
            rng = self._rng("cancel", rid)
            if rng.uniform() < self.rates.cancel_prob:
                stage = CANCEL_STAGES[int(rng.integers(len(CANCEL_STAGES)))]
                point = (stage, int(rng.integers(1, 4)))  # 1st..3rd sight
        self._cancel_memo[rid] = point
        return point

    def should_cancel(self, req, stage: str) -> bool:
        """True exactly once: the ``nth`` time ``req`` is observed in its
        sampled cancel stage."""
        point = self._cancel_point(req.rid)
        if point is None or point[0] != stage:
            return False
        seen = self._stage_seen.get((req.rid, stage), 0) + 1
        self._stage_seen[(req.rid, stage)] = seen
        if seen == point[1]:
            self.injected["cancel"] += 1
            return True
        return False

    # -- deadlines ---------------------------------------------------------
    def deadline_for(self, req) -> float | None:
        """Deadline in seconds after arrival, or None (no deadline)."""
        rid = req.rid
        if rid in self._deadline_memo:
            return self._deadline_memo[rid]
        rel = self.deadlines.get(rid)
        if rel is None and self.rates.deadline_prob > 0:
            rng = self._rng("deadline", rid)
            if rng.uniform() < self.rates.deadline_prob:
                rel = float(rng.uniform(self.rates.deadline_min_s,
                                        self.rates.deadline_max_s))
        if rel is not None:
            self.injected["deadline"] += 1
        self._deadline_memo[rid] = rel
        return rel

    # -- encoder chunk faults ----------------------------------------------
    def _encoder_failures(self, rid: str) -> int:
        n = self._encoder_memo.get(rid)
        if n is None:
            n = self.encoder_faults.get(rid, 0)
            if n == 0 and self.rates.encoder_fault_prob > 0:
                rng = self._rng("encoder", rid)
                if rng.uniform() < self.rates.encoder_fault_prob:
                    n = self._severity(rng)
            self._encoder_memo[rid] = n
        return n

    def encoder_fault(self, req) -> bool:
        """True while the request's sampled failure budget lasts: the
        first ``n`` encode chunks of a faulted request fail, then it
        heals (or never does, if permanent)."""
        n = self._encoder_failures(req.rid)
        if n <= 0:
            return False
        attempt = self._encode_attempts.get(req.rid, 0) + 1
        self._encode_attempts[req.rid] = attempt
        if attempt <= n:
            self.injected["encoder"] += 1
            return True
        return False

    # -- executor step faults ----------------------------------------------
    def step_fault(self, iteration: int, attempt: int) -> bool:
        """True while the iteration's sampled failure budget outlasts
        ``attempt`` (0-based retry counter within the iteration)."""
        n = self._step_memo.get(iteration)
        if n is None:
            n = self.step_faults.get(iteration, 0)
            if n == 0 and self.rates.step_fault_prob > 0:
                rng = self._rng("step", iteration)
                if rng.uniform() < self.rates.step_fault_prob:
                    n = self._severity(rng)
            self._step_memo[iteration] = n
        if attempt < n:
            self.injected["step"] += 1
            return True
        return False

    # -- replica crashes ---------------------------------------------------
    def kill_time(self, replica: int) -> float | None:
        return self.replica_kills.get(replica)

    def restart_delay(self, replica: int) -> float | None:
        """Seconds after death until a fresh engine restarts in this
        replica's slot, or None — it stays down."""
        return self.restart_delays.get(replica)

    # -- page-chain migration faults -----------------------------
    def migration_fault(self, rid: str, chunk: int,
                        attempt: int) -> str | None:
        """Fault for transferring ``chunk`` of ``rid``'s page chain on
        (0-based) retry ``attempt``: ``"timeout"`` (the chunk never
        arrives within the chunk timeout), ``"corrupt"`` (it arrives but
        checksum verification rejects it), or None. Like every injection,
        hashed purely from (seed, kind, rid, chunk) so a replay sees the
        identical fault sequence regardless of when the migration runs."""
        key = (rid, chunk)
        ent = self._migration_memo.get(key)
        if ent is None:
            ent = self.migration_faults.get(key)
            if ent is None:
                kind, n = None, 0
                pt = self.rates.migration_timeout_prob
                pc = self.rates.migration_corrupt_prob
                if pt > 0 or pc > 0:
                    rng = self._rng("migration", f"{rid}:{chunk}")
                    u = rng.uniform()
                    if u < pt:
                        kind, n = "timeout", self._severity(rng)
                    elif u < pt + pc:
                        kind, n = "corrupt", self._severity(rng)
                ent = (kind, n)
            self._migration_memo[key] = ent
        kind, n = ent
        if kind is not None and attempt < n:
            self.injected["mig_" + kind] += 1
            return kind
        return None

    # -- reporting ---------------------------------------------------------
    def describe(self) -> dict:
        return {
            "seed": self.seed,
            "rates": vars(self.rates).copy(),
            "explicit": {
                "cancels": len(self.cancels),
                "deadlines": len(self.deadlines),
                "encoder_faults": len(self.encoder_faults),
                "step_faults": len(self.step_faults),
                "replica_kills": dict(self.replica_kills),
                "migration_faults": len(self.migration_faults),
                "restart_delays": dict(self.restart_delays),
            },
            "injected": dict(self.injected),
        }
