"""p90 of wall-clock TTFT over the text requests due in the window (the
traffic's modality label, not the classifier's class; in a traced run,
those due before the profiler opened)."""
from servebench.metrics._common import p90


def read(run):
    return p90([run.ttft(s) for s in run.untraced()
                if s.item.modality == "text"])
