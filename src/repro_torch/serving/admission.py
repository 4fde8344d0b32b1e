"""Overload control: SLO-aware admission + the brownout ladder.

Past the capacity knee, responsiveness is an *overload-control* problem,
not a scheduling one: an engine that accepts every arrival grows its
queues without bound and every SLO is eventually lost. This module gives
the serving tier one graded degradation policy with two halves:

``AdmissionController``
    Decides at ingest — deterministically, from engine state only, never
    from an RNG — whether a classified request can be served at all:

      * bounded per-class queue depth (rocks get the shortest queue,
        sand the longest: a queued rock is hours of work, a queued
        motorcycle is milliseconds);
      * per-tenant token buckets (prompt tokens as the budget currency;
        a bucket never goes negative — a request either fits or is
        refused whole);
      * an SLO feasibility test: predicted TTFT at admission — the
        executor's isolated-e2e estimate plus the backlog already
        queued/prefilling ahead of it — against the request's remaining
        SLO budget. The headroom is *modality-aware*: rocks are judged
        at 1x, pebbles and sand at increasingly lenient multipliers, so
        under pressure rocks are refused first and motorcycles last
        (the paper's abstraction applied to overload).

    A refused request enters the terminal ``REJECTED`` state through the
    engine's exactly-once release machinery (``Engine._abort``) — never
    FAILED/CANCELLED, visible separately in metrics.

``BrownoutLadder``
    Before any rejection, *sustained* pressure (admission blocked on KV
    pages) steps through graded service degradation:

      rung 1  ``encode``        shrink rock encode chunks (a truck's
                                per-iteration encode share is capped, so
                                pebble/sand encodes keep flowing);
      rung 2  ``defer_trucks``  stop admitting waiting trucks to prefill
                                (admitted trucks continue);
      rung 3  ``publication``   tighten prefix-cache publication (skip
                                popularity-gated index growth; preempted
                                victims still self-publish);
      top     shed              modality-aware load shedding — the original
                                ``load_shed`` absorbed: one ladder, not
                                two pressure policies.

    Hysteresis: climbing takes ``step_iters`` consecutive pressure
    iterations per rung, descending takes ``cooldown_iters`` clean ones
    — the ladder cannot oscillate at a fixed boundary load, because one
    clean iteration resets the climb counter while descent needs a long
    clean streak. The legacy ``EngineConfig.load_shed`` knob maps onto a
    rung-free ladder (``rungs=()``, ``cooldown_iters=1``) that
    reproduces the original shed cadence exactly.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.serving.request import Request, VehicleClass

#: default feasibility headroom per class, in VehicleClass enum order
#: (motorcycle, car, truck): the knob that makes rejection modality-
#: aware. Rocks are judged conservatively (below their nominal budget):
#: admitting an infeasible truck strands minutes of GPU work that then
#: delays everything behind it, while an optimistically-admitted
#: motorcycle risks only milliseconds — so sand gets 2.5x slack and
#: rocks must clear 0.7x.
DEFAULT_HEADROOM = {
    VehicleClass.MOTORCYCLE: 2.5,
    VehicleClass.CAR: 1.2,
    VehicleClass.TRUCK: 0.7,
}

#: default bounded queue depth per class (None = unbounded). Rocks queue
#: shortest: each one parked is minutes of GPU work promised and not
#: started, which is exactly the backlog the feasibility test fights.
DEFAULT_QUEUE_DEPTH = {
    VehicleClass.MOTORCYCLE: 512,
    VehicleClass.CAR: 256,
    VehicleClass.TRUCK: 64,
}


@dataclass(frozen=True)
class TenantBudget:
    """One tenant's token-bucket parameters (prompt tokens as currency).
    The defaults are infinite — a tenant without an explicit budget is
    never refused for budget reasons."""
    rate: float = float("inf")    # tokens/second refill
    burst: float = float("inf")   # bucket capacity


class TokenBucket:
    """Classic token bucket on the engine's simulated clock. By
    construction the level can never go negative: ``take`` refuses any
    request the current level cannot cover whole."""
    __slots__ = ("rate", "burst", "level", "last", "min_level")

    def __init__(self, budget: TenantBudget, now: float):
        self.rate = budget.rate
        self.burst = budget.burst
        self.level = budget.burst
        self.last = now
        self.min_level = budget.burst

    def refill(self, now: float) -> None:
        if now > self.last and self.rate != float("inf"):
            self.level = min(self.burst,
                             self.level + self.rate * (now - self.last))
        self.last = max(self.last, now)

    def take(self, amount: float, now: float) -> bool:
        self.refill(now)
        if self.level == float("inf"):
            return True
        if amount > self.level:
            return False
        self.level -= amount
        self.min_level = min(self.min_level, self.level)
        return True


@dataclass(frozen=True)
class AdmissionConfig:
    """Knobs for the SLO-aware admission controller. The defaults are
    deliberately permissive: infinite tenant budgets, generous queue
    bounds, headroom >= 1 — an under-capacity run admits everything, so
    installing the layer is behaviour-identical until real pressure."""
    # SLO feasibility: predicted_ttft <= remaining_budget * headroom[class]
    slo_feasibility: bool = True
    headroom: dict = field(default_factory=lambda: dict(DEFAULT_HEADROOM))
    # each brownout level tightens the headroom by this fraction, so the
    # ladder and the admission gate are one escalating policy
    pressure_tighten: float = 0.25
    # backlog model: seconds of queued + in-flight prefill ahead of the
    # candidate, weighted (1.0 = trust the estimator sums as-is)
    backlog_weight: float = 1.0
    # bounded per-class queue depth (None disables the bound entirely)
    max_queue_depth: dict | None = field(
        default_factory=lambda: dict(DEFAULT_QUEUE_DEPTH))
    # per-tenant budgets; tenants not listed get ``default_budget``
    default_budget: TenantBudget = field(default_factory=TenantBudget)
    tenant_budgets: dict = field(default_factory=dict)


class AdmissionController:
    """Deterministic per-request admit/reject decisions at ingest.

    Stateful only through the tenant buckets and counters; every
    decision is a pure function of (request, engine state, clock), so a
    replayed workload re-derives the identical rejection set."""

    def __init__(self, cfg: AdmissionConfig):
        self.cfg = cfg
        self.buckets: dict[str, TokenBucket] = {}
        self.admitted = 0
        self.rejections: dict[str, int] = {}   # reason -> count

    # -- accounting --------------------------------------------------------
    def _reject(self, reason: str) -> str:
        self.rejections[reason] = self.rejections.get(reason, 0) + 1
        return reason

    def min_bucket_level(self) -> float:
        """Lowest level any tenant bucket ever reached (gate: >= 0)."""
        if not self.buckets:
            return float("inf")
        return min(b.min_level for b in self.buckets.values())

    def bucket_for(self, tenant: str, now: float) -> TokenBucket:
        b = self.buckets.get(tenant)
        if b is None:
            budget = self.cfg.tenant_budgets.get(
                tenant, self.cfg.default_budget)
            b = TokenBucket(budget, now)
            self.buckets[tenant] = b
        return b

    # -- the feasibility model --------------------------------------------
    #: classes whose backlog runs ahead of (or alongside) each class
    #: under TCM's sand-first discipline: a motorcycle only waits behind
    #: other motorcycles; a truck waits behind everything. Class-blind
    #: backlog would invert the rejection order — sand's absolute SLO
    #: budget is tiny, so charging it the trucks' queue rejects
    #: motorcycles first, the exact opposite of the paper's abstraction.
    _AHEAD = {
        VehicleClass.MOTORCYCLE: (VehicleClass.MOTORCYCLE,),
        VehicleClass.CAR: (VehicleClass.MOTORCYCLE, VehicleClass.CAR),
        VehicleClass.TRUCK: tuple(VehicleClass),
    }

    def predict_ttft(self, req: Request, engine) -> float:
        """Predicted time to first token if admitted now: the isolated
        e2e estimate plus every second of estimated prefill that will be
        scheduled ahead of this request — queued or in-flight work of
        the classes TCM serves at or above this request's priority."""
        ahead = self._AHEAD[req.vclass]
        backlog = sum(engine.queues.queues[c].est_prefill_sum
                      for c in ahead)
        backlog += sum(engine.encode_queues.queues[c].est_prefill_sum
                       for c in ahead)
        for r in engine.prefilling:
            if r.vclass in ahead and r.prompt_tokens > 0:
                backlog += r.est_prefill * \
                    (1.0 - r.prefilled / r.prompt_tokens)
        return (self.cfg.backlog_weight * backlog
                + engine.executor.isolated_e2e(req))

    # -- the decision ------------------------------------------------------
    def decide(self, req: Request, engine) -> str | None:
        """None = admit; otherwise the (deterministic) rejection reason.
        Order matters: cheap structural bounds first, the feasibility
        model second, and the tenant bucket last — a request that could
        never run must not drain its tenant's budget."""
        cfg = self.cfg
        now = engine.now
        if cfg.max_queue_depth is not None:
            cap = cfg.max_queue_depth.get(req.vclass)
            if cap is not None:
                depth = (len(engine.queues.queues[req.vclass])
                         + len(engine.encode_queues.queues[req.vclass]))
                if depth >= cap:
                    return self._reject(
                        f"admission: {req.vclass.value} queue full "
                        f"({depth}/{cap})")
        if cfg.slo_feasibility and req.slo != float("inf"):
            headroom = cfg.headroom.get(req.vclass, 1.0)
            level = engine.ladder.level if engine.ladder is not None else 0
            headroom /= (1.0 + level * cfg.pressure_tighten)
            budget = req.slo - (now - req.arrival)
            predicted = self.predict_ttft(req, engine)
            if predicted > budget * headroom:
                return self._reject(
                    f"admission: SLO infeasible (predicted TTFT "
                    f"{predicted:.2f}s > {budget:.2f}s x "
                    f"{headroom:.2f} {req.vclass.value} headroom)")
        if not self.bucket_for(req.tenant, now).take(req.prompt_tokens, now):
            return self._reject(
                f"admission: tenant {req.tenant} budget exhausted")
        self.admitted += 1
        return None

    def describe(self) -> dict:
        return {
            "admitted": self.admitted,
            "rejections": dict(self.rejections),
            "min_bucket_level": self.min_bucket_level(),
            "tenants_seen": sorted(self.buckets),
        }


@dataclass(frozen=True)
class BrownoutConfig:
    """Hysteresis + rung set for the brownout ladder. ``rungs`` are the
    graded degradations climbed in order under sustained pressure; the
    shed stage sits above the last rung (enable with ``shed=True``).
    An empty ``rungs`` tuple with ``shed=True`` and ``cooldown_iters=1``
    is exactly the original ``load_shed`` behaviour (the legacy mapping)."""
    step_iters: int = 20        # pressure iterations to climb one rung
    cooldown_iters: int = 60    # clean iterations to descend one rung
    rungs: tuple = ("encode", "defer_trucks", "publication")
    shed: bool = True
    # rung "encode": cap a truck's per-iteration encode chunk at this
    # fraction of the configured encode budget
    encode_chunk_frac: float = 0.25


class BrownoutLadder:
    """Graded-degradation state machine driven once per engine iteration
    by the page-pressure signal (``observe``). ``level`` counts active
    rungs; at the top, ``observe`` returning True asks the engine to
    shed one waiting rock (the engine confirms via ``shed_fired`` so an
    un-sheddable iteration — no rock waiting — retries immediately,
    matching the original shed cadence bit-for-bit under the legacy mapping)."""

    def __init__(self, cfg: BrownoutConfig):
        self.cfg = cfg
        self.level = 0
        self.transitions = 0     # climb+descend count (hysteresis gauge)
        self._up = 0             # consecutive pressure iterations
        self._down = 0           # consecutive clean iterations

    def active(self, rung: str) -> bool:
        """Is the named degradation currently engaged?"""
        rungs = self.cfg.rungs
        return rung in rungs and self.level > rungs.index(rung)

    def observe(self, pressure: bool) -> bool:
        """Advance the hysteresis counters; True = shed one request."""
        cfg = self.cfg
        if pressure:
            self._down = 0
            self._up += 1
            if self.level < len(cfg.rungs):
                if self._up >= cfg.step_iters:
                    self.level += 1
                    self.transitions += 1
                    self._up = 0
                return False
            return cfg.shed and self._up >= cfg.step_iters
        self._up = 0
        self._down += 1
        if self._down >= cfg.cooldown_iters and self.level > 0:
            self.level -= 1
            self.transitions += 1
            self._down = 0
        return False

    def shed_fired(self) -> None:
        """A shed actually happened: half-reset the streak so continued
        pressure sheds gradually (one rock per step_iters//2 pressured
        iterations), not one per iteration."""
        self._up = self.cfg.step_iters // 2

    def describe(self) -> dict:
        return {"level": self.level, "rungs": list(self.cfg.rungs),
                "transitions": self.transitions}


def legacy_shed_config(shed_after_iters: int) -> BrownoutConfig:
    """The original ``load_shed`` expressed as a ladder: no graded rungs, shed
    at ``shed_after_iters`` of sustained pressure, full reset on any
    clean iteration (cooldown 1 — there is no level to hold)."""
    return BrownoutConfig(step_iters=shed_after_iters, cooldown_iters=1,
                          rungs=(), shed=True)
