"""p90 over requests of each request's mean gap between output tokens:
(last stamped token - first token) / (tokens - 1), over requests with two
tokens or more, in ms. In a traced run, over the requests due before the
profiler opened and the tokens stamped before it."""
from servebench.metrics._common import p90


def read(run):
    gaps = []
    for s in run.untraced():
        t = [x for x in s.token_times if x < run.traced_from]
        if len(t) >= 2:
            gaps.append((t[-1] - t[0]) / (len(t) - 1))
    v = p90(gaps)
    return None if v is None else v * 1e3
