"""Ms of the ``isolated_run`` calls that ingest made in the window before
the profiler opened (the whole-prompt prefill each arriving request pays
to price its SLO), summed and divided by the requests due then. Read by
every ``admission_profile_ms.<x>`` metric."""


def read(run):
    due = run.untraced()
    if not due or not run.steps:
        return None
    end = min(run.close, run.traced_from)
    total = sum(dt for t, dt, _n, _p in run.admissions if t < end)
    return total / len(due) * 1e3
