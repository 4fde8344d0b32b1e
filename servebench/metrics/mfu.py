"""The window's model operations over (the model steps' wall time x the
H100's 989 TFLOP/s), in %. The operations are the benchmark's own count
(``servebench/work.py``) from the rows each step computed; the admission
profile prefills run outside the model step and are left out of both
sides, and so are the steps under the profiler. Read by every
``mfu.<x>`` metric."""
from servebench import work
from servebench.metrics._common import window_steps


def read(run):
    steps = window_steps(run)
    wall = sum(s.seconds for s in steps)
    if not steps or wall <= 0:
        return None
    flops = sum(work.step_flops(run.model, [(a, n) for a, n, _w in s.prefill],
                                s.decode, s.emitting) for s in steps)
    return 100.0 * flops / (wall * work.PEAK_FLOPS)
