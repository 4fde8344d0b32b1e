"""Spans and counters on the port's serving path, off by default.

``span(name)`` times a region of host code. Off, it returns one shared
no-op context: one global read, no clock, no allocation. On, it appends
``(name, t0, t1, parent)`` to ``records`` on
``time.perf_counter()`` (``parent``: the index of the enclosing open span,
or None) and opens ``torch.profiler.record_function(name)``, so that under
a running profiler the span lands in the Kineto trace beside the kernels,
on the device trace's clock. ``records`` holds at most ``CAP`` spans and
counts the rest in ``dropped``.

``count(name, n=1)`` adds to an integer counter, on or off.

Nothing here writes anything out: the profiler's trace carries the spans,
and a reader takes ``records`` and ``snapshot()`` in-process.
"""
from __future__ import annotations

import time

from torch.profiler import record_function

CAP = 1 << 20

records: list = []              # (name, t0, t1, parent) per span
counters: dict[str, int] = {}
dropped = 0
_on = False
_open: list = []                # indices of the open spans, innermost last


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "i", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global dropped
        self.rf = record_function(self.name)
        self.rf.__enter__()
        self.i = len(records)
        if self.i < CAP:
            records.append(None)        # filled in at exit
        else:
            self.i = None
            dropped += 1
        _open.append(self.i)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        _open.pop()
        if self.i is not None:
            records[self.i] = (self.name, self.t0, t1,
                               _open[-1] if _open else None)
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager timing ``name``."""
    if not _on:
        return _NOOP
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    counters[name] = counters.get(name, 0) + n


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    """Forget every record, counter and drop (on or off stays as it is)."""
    global records, dropped
    records = []
    counters.clear()
    dropped = 0
    _open.clear()


def snapshot() -> dict:
    """The counters, the number of records and of drops so far: a reader
    cuts ``records`` at a window's boundary with it."""
    return {"records": len(records), "dropped": dropped,
            "counters": dict(counters)}
