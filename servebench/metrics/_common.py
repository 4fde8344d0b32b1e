"""Arithmetic the metric readers share: percentiles as
``serving/metrics.summarize`` takes them (numpy's linear interpolation),
and the step records of the window."""
from __future__ import annotations

import numpy as np


def p90(values) -> float | None:
    values = [v for v in values if v is not None]
    return float(np.percentile(values, 90)) if values else None


def window_steps(run):
    """The window's model steps before the profiler opened."""
    return [s for s in run.steps if s.t < min(run.close, run.traced_from)]
