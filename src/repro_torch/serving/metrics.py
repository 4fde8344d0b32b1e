"""Aggregate serving metrics (the paper's reported quantities)."""
from __future__ import annotations

import numpy as np

from .request import Request, State

GROUPS = ("motorcycle", "car", "truck", "overall")


def lifecycle_counts(reqs: list[Request]) -> dict:
    """How every request ended: the chaos benchmark asserts
    these partition the workload — each request reaches exactly one
    terminal state, none is lost in flight, none finishes twice."""
    by_state: dict[str, int] = {}
    for r in reqs:
        by_state[r.state.value] = by_state.get(r.state.value, 0) + 1
    return {
        "finished": by_state.get(State.FINISHED.value, 0),
        "rejected": by_state.get(State.REJECTED.value, 0),
        "failed": by_state.get(State.FAILED.value, 0),
        "cancelled": by_state.get(State.CANCELLED.value, 0),
        "in_flight": sum(n for s, n in by_state.items()
                         if s not in ("finished", "rejected", "failed",
                                      "cancelled")),
        "shed": sum(1 for r in reqs
                    if r.error is not None and r.error.startswith(
                        "load shed")),
        "redispatched": sum(1 for r in reqs if r.redispatches > 0),
    }


def _group(reqs: list[Request], g: str) -> list[Request]:
    if g == "overall":
        return reqs
    return [r for r in reqs if r.vclass is not None and r.vclass.value == g]


def summarize(reqs: list[Request]) -> dict:
    """Per-class + overall: TTFT, normalized latency, SLO violation rate &
    severity, preemption counts/time (paper Figs. 3/8/10/11...).

    Latency statistics (TTFT / norm latency / SLO violation) are computed
    over COMPLETED requests only: a rejected or failed request
    has no meaningful latency, and folding its partial timestamps into
    percentiles skews them.  Non-completed outcomes are reported as
    separate counts instead, so overload runs stay honest — a policy
    cannot 'improve' its p90 by rejecting its slowest class."""
    out = {}
    for g in GROUPS:
        rs = _group(reqs, g)
        if not rs:
            out[g] = None
            continue
        done = [r for r in rs if r.state is State.FINISHED]
        ttft = np.array([r.ttft() for r in done if r.ttft() is not None])
        norm = np.array([r.norm_latency() for r in done
                         if r.norm_latency() is not None])
        viol = np.array([r.slo_violated() for r in done])
        sev = np.array([r.violation_severity() for r in done
                        if r.slo_violated()])
        mm = [r for r in done if r.mm_units > 0]
        enc_waits = [bd["encode_wait"] for r in mm
                     if (bd := r.ttft_breakdown()) is not None]
        out[g] = {
            "n": len(rs),
            "finished": len(done),
            "rejected": sum(r.state is State.REJECTED for r in rs),
            "failed": sum(r.state is State.FAILED for r in rs),
            "cancelled": sum(r.state is State.CANCELLED for r in rs),
            "shed": sum(1 for r in rs if r.error is not None
                        and r.error.startswith("load shed")),
            "ttft_avg": float(ttft.mean()) if len(ttft) else float("nan"),
            "ttft_p90": float(np.percentile(ttft, 90)) if len(ttft) else float("nan"),
            "ttft_p99": float(np.percentile(ttft, 99)) if len(ttft) else float("nan"),
            "norm_latency_avg": float(norm.mean()) if len(norm) else float("nan"),
            "slo_violation_rate": float(viol.mean()) if len(viol) else 0.0,
            "violation_severity_avg": float(sev.mean()) if len(sev) else 0.0,
            "preemptions": int(sum(r.preemptions for r in rs)),
            "preempted_time": float(sum(r.preempted_time for r in rs)),
            # decoupled encode stage (mm requests only)
            "encode_wait_avg": (float(np.mean(enc_waits)) if enc_waits
                                else 0.0),
            "encode_cache_hit_rate": (sum(r.encode_cache_hit for r in mm)
                                      / len(mm) if mm else 0.0),
            # KV prefix cache: prompt tokens served from cached pages
            "cached_prefix_tokens": int(sum(r.cached_prefix_tokens
                                            for r in rs)),
            "prefix_hit_rate": (sum(r.cached_prefix_tokens > 0 for r in rs)
                                / len(rs)),
        }
    return out


def summarize_tenants(reqs: list[Request],
                      duration: float | None = None) -> dict:
    """Per-tenant goodput / rejection / attainment counters.

    The fairness check the benchmark gates on: under overload no tenant
    may be fully starved (zero served) at a vehicle class where another
    tenant is being served — modality-aware rejection must discriminate
    by *class*, never by client identity."""
    tenants = sorted({r.tenant for r in reqs})
    if duration is None and reqs:
        t0 = min(r.arrival for r in reqs)
        t1 = max((r.finish_time for r in reqs
                  if r.finish_time is not None), default=t0)
        duration = max(t1 - t0, 1e-9)
    out = {}
    for t in tenants:
        rs = [r for r in reqs if r.tenant == t]
        done = [r for r in rs if r.state is State.FINISHED]
        ok = [r for r in done if not r.slo_violated()]
        served_by_class = {g: sum(1 for r in done if r.vclass is not None
                                  and r.vclass.value == g)
                           for g in GROUPS[:3]}
        rejected_by_class = {g: sum(1 for r in rs
                                    if r.state is State.REJECTED
                                    and r.vclass is not None
                                    and r.vclass.value == g)
                             for g in GROUPS[:3]}
        out[t] = {
            "n": len(rs),
            "finished": len(done),
            "rejected": sum(r.state is State.REJECTED for r in rs),
            "slo_attainment": (len(ok) / len(rs)) if rs else 0.0,
            "goodput": len(ok) / duration if duration else 0.0,
            "served_by_class": served_by_class,
            "rejected_by_class": rejected_by_class,
        }
    return out


def summarize_fleet(fleet) -> dict:
    """Per-replica fleet-tier counters: lifecycle state,
    migrations attempted/succeeded/fallen-back, drain durations,
    repartition and health-transition events — the operator's view of a
    ``serving.fleet.Fleet`` run, surfaced in the fleet benchmark summary.
    Works on a plain ``Router`` too (fleet-only fields read as zero)."""
    n = len(fleet.engines)

    def _per(attr, default=0):
        v = getattr(fleet, attr, None)
        return v if v is not None else [default] * n

    states = getattr(fleet, "replica_state", None)
    mig_out, mig_in = _per("migrations_out"), _per("migrations_in")
    replicas = []
    for i, eng in enumerate(fleet.engines):
        replicas.append({
            "replica": i,
            "state": (states[i].value if states is not None
                      else ("alive" if fleet.alive[i] else "dead")),
            "alive": fleet.alive[i],
            "clock": eng.now,
            "finished": len(eng.finished),
            "migrations_out": mig_out[i],
            "migrations_in": mig_in[i],
            "used_pages": eng.allocator.used_pages,
            "pinned_encoder_entries": (
                eng.encoder_cache.stats()["pinned"]
                if eng.encoder_cache is not None else 0),
            "journal_records": (len(eng.journal)
                                if getattr(eng, "journal", None) is not None
                                else 0),
        })
    drains = getattr(fleet, "drain_events", [])
    return {
        "replicas": replicas,
        "migrations": {
            "attempted": getattr(fleet, "migrations_attempted", 0),
            "succeeded": getattr(fleet, "migrations_succeeded", 0),
            "fallbacks": getattr(fleet, "migration_fallbacks", 0),
            "noops": getattr(fleet, "migration_noops", 0),
            "retries": getattr(fleet, "migration_retries", 0),
            "pages_transferred": getattr(fleet, "migrated_pages", 0),
            "pages_deduped": getattr(fleet, "deduped_pages", 0),
        },
        "drain_events": drains,
        "drain_duration_avg": (sum(d["duration"] for d in drains)
                               / len(drains) if drains else 0.0),
        "repartition_events": getattr(fleet, "repartition_events", []),
        "health_events": getattr(fleet, "health_events", []),
        "kill_events": fleet.kill_events,
        "redispatched": fleet.redispatched,
        "lost": len(fleet.lost),
        # crash recovery: restart/rejoin history + the
        # journal-replay cross-check tally (zero-length fleet fields
        # when summarizing a plain Router)
        "restart_events": getattr(fleet, "restart_events", []),
        "journal_checks": getattr(fleet, "journal_checks", 0),
        "journal_mismatches": list(getattr(fleet, "journal_mismatches",
                                           [])),
    }


def rejection_mix(reqs: list[Request]) -> dict:
    """Rejected-request fractions by vehicle class: of all offered
    requests in a class, what share was refused at admission.  The
    benchmark asserts the modality-aware order — trucks refused at the
    highest rate, motorcycles at the lowest."""
    out = {}
    for g in GROUPS[:3]:
        rs = [r for r in reqs if r.vclass is not None and r.vclass.value == g]
        rej = sum(r.state is State.REJECTED for r in rs)
        out[g] = {"offered": len(rs), "rejected": rej,
                  "rate": rej / len(rs) if rs else 0.0}
    return out


def slo_attainment(reqs: list[Request]) -> float:
    """Fraction of ALL offered requests that finished within their SLO —
    rejections and failures count against attainment (the closed-loop
    quantity ROADMAP open item 3 asks for)."""
    if not reqs:
        return 0.0
    ok = sum(1 for r in reqs
             if r.state is State.FINISHED and not r.slo_violated())
    return ok / len(reqs)


def ttft_components(reqs: list[Request]) -> dict[str, float] | None:
    """Mean per-stage TTFT decomposition over finished requests: where did
    the time to first token actually go (encode-wait vs prefill-wait vs
    queue-wait; benchmarks/ttft_breakdown.py)."""
    parts = [bd for r in reqs if (bd := r.ttft_breakdown()) is not None]
    if not parts:
        return None
    n = len(parts)
    return {k: sum(p[k] for p in parts) / n for k in parts[0]}


def goodput(reqs: list[Request], duration: float | None = None) -> float:
    """Requests/second finishing within their SLO (paper Fig. 15)."""
    ok = [r for r in reqs if r.finish_time is not None and not r.slo_violated()]
    if not ok:
        return 0.0
    if duration is None:
        t0 = min(r.arrival for r in reqs)
        t1 = max(r.finish_time for r in reqs if r.finish_time is not None)
        duration = max(t1 - t0, 1e-9)
    return len(ok) / duration


def fmt_table(summary: dict, title: str = "") -> str:
    lines = []
    if title:
        lines.append(f"== {title} ==")
    hdr = f"{'class':<12}{'n':>5}{'TTFT avg':>10}{'TTFT p90':>10}" \
          f"{'norm lat':>10}{'SLO viol':>10}{'severity':>10}{'preempt':>9}"
    lines.append(hdr)
    for g in GROUPS:
        s = summary.get(g)
        if s is None:
            continue
        lines.append(
            f"{g:<12}{s['n']:>5}{s['ttft_avg']:>10.3f}{s['ttft_p90']:>10.3f}"
            f"{s['norm_latency_avg']:>10.4f}{s['slo_violation_rate']:>10.1%}"
            f"{s['violation_severity_avg']:>10.2f}{s['preemptions']:>9}")
    return "\n".join(lines)
