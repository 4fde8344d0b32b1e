"""Host ms an engine step spends outside the model step and the admission
profile prefills (ingest, classification, planning, bookkeeping), summed
over the window's steps before the profiler opened and divided by their
number. Read by every ``engine_ms_per_step.<x>`` metric."""


def read(run):
    end = min(run.close, run.traced_from)
    steps = [h for t, h in run.engine_steps if t < end]
    return sum(steps) / len(steps) * 1e3 if steps else None
