"""p90 of wall-clock TTFT, from each request's due time, over every request
due in the window (one with no first token by the drain's cap at the cap;
in a traced run, those due before the profiler opened)."""
from servebench.metrics._common import p90


def read(run):
    return p90([run.ttft(s) for s in run.untraced()])
