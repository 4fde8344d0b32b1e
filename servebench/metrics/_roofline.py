"""A paged kernel's share of its roofline over the traced sub-window: the
sum over its calls of each call's least time (``work.bound_s`` of the
frozen byte and operation counts, at the call's padded geometry), over
the profiler's device time of the kernel's launches, in %. Every call in
the sub-window counts, the admission profile prefills' included."""
from __future__ import annotations

from servebench import work


def _sizes(run):
    m = run.model
    H, KV = m["num_heads"], m["num_kv_heads"]
    hd = m.get("head_dim") or m["d_model"] // H
    srv = run.config["serving"]
    return H, KV, hd, m["num_layers"], srv["page_size"], srv["max_len"]


def prefill_bound_s(run) -> float:
    H, KV, hd, L, page, max_len = _sizes(run)
    calls = []
    for s in run.steps:
        if not s.profiled:
            continue
        for wave in sorted({w for _a, _n, w in s.prefill}):
            calls.append([(a, n) for a, n, w in s.prefill if w == wave])
    calls += [[(0, n)] for _t, _dt, n, prof in run.admissions if prof]
    total = 0.0
    for rows in calls:
        starts = [a for a, _n in rows]
        lens = [n for _a, n in rows]
        table = work.table_width(max(-(-(a + n) // page) for a, n in rows),
                                 max_len, page)
        total += work.bound_s(*work.prefill_work(
            starts, lens, work.bucket(max(lens)), H, KV, hd,
            work.bucket(len(rows)), table))
    return total * L


def decode_bound_s(run) -> float:
    H, KV, hd, L, page, max_len = _sizes(run)
    total = 0.0
    for s in run.steps:
        if not s.profiled or not s.decode:
            continue
        table = work.table_width(max(-(-c // page) for c in s.decode),
                                 max_len, page)
        total += work.bound_s(*work.decode_work(
            s.decode, H, KV, hd, work.bucket(len(s.decode)), table))
    return total * L


def share(run, bound_s, names) -> float | None:
    """``bound_s`` over the device seconds of the kernels whose (demangled)
    names contain one of ``names``."""
    tr = run.trace
    if not tr:
        return None
    dev = sum(v for k, v in tr["kernels"].items()
              if any(n in k for n in names))
    if dev <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / dev
