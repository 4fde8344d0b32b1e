"""``repro_torch.obs`` and the spans of the port's ``ModelExecutor`` on the
CPU: off, a span is one shared no-op; on, the executor's spans nest as its
layers do and cover each iteration; ``exec.syncs`` counts what the plan
makes it issue, on or off; and tracing leaves the tokens alone."""
import dataclasses

import pytest
import torch

from repro_torch import configs, obs
from repro_torch.cache import BlockAllocator
from repro_torch.serving import executors as E
from repro_torch.serving.request import Modality, Request, State

MAX_LEN, PAGE, CHUNK, ENCODE = 64, 16, 12, 128
# (rid, modality, prompt tokens, output tokens, encoder units)
SPECS = [("t0", Modality.TEXT, 23, 4, 0), ("i1", Modality.IMAGE, 30, 3, 40),
         ("v2", Modality.VIDEO, 45, 5, 300), ("t3", Modality.TEXT, 9, 3, 0)]
# the step at which t0's prompt runs as two chunks of one plan (two waves)
TWO_WAVES_AT = 0
LEAVES = {"exec.pack", "exec.upload", "exec.forward", "exec.readback",
          "exec.sync", "exec.encode"}
CALL = {"exec.pack", "exec.upload", "exec.forward", "exec.readback"}


@pytest.fixture(autouse=True)
def _clean():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


class _Spy:
    """Stands in for ``torch.profiler.record_function``, counting entries."""
    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _Spy.entered += 1
        return self

    def __exit__(self, *exc):
        return False


def _executor():
    cfg = dataclasses.replace(configs.get_reduced("chatglm3-6b"),
                              dtype=torch.float32)
    return E.ModelExecutor(cfg, E.ExecutorConfig(max_slots=4, max_len=MAX_LEN,
                                                 page_size=PAGE),
                           device="cpu")


def _plan(reqs, left, step):
    """(prefill work, decode requests, encode work) of one step: encode
    chunks first, then prefill chunks of the encoded prompts, and decode."""
    encode = [(r, min(ENCODE, left[r.rid])) for r in reqs
              if r.state is State.ENCODING]
    prefill = []
    for r in reqs:
        if r.state is not State.PREFILLING:
            continue
        rest = r.prompt_tokens - r.prefilled
        if step == TWO_WAVES_AT and r.rid == "t0":
            prefill += [(r, CHUNK), (r, rest - CHUNK)]
        else:
            prefill.append((r, min(CHUNK, rest)))
    decode = [r for r in reqs if r.state is State.RUNNING]
    return prefill, decode, encode


def _drive(on: bool):
    """Admission profiles, then engine-like steps to the end; returns the
    tokens, and per admission and per step the syncs the counter saw and
    the syncs the plan implies."""
    ex = _executor()
    alloc = BlockAllocator(num_pages=64, page_size=PAGE)
    ex.bind_allocator(alloc)
    reqs = [Request(rid=rid, modality=m, arrival=0.0, text_tokens=p,
                    mm_units=u, prompt_tokens=p, output_tokens=o)
            for rid, m, p, o, u in SPECS]
    left = {r.rid: r.mm_units for r in reqs}
    real_rf, obs.record_function, _Spy.entered = obs.record_function, _Spy, 0
    if on:
        obs.enable()
    counted, implied, encodes = [], [], 0

    def syncs():
        return obs.snapshot()["counters"].get("exec.syncs", 0)
    try:
        for r in reqs:
            before = syncs()
            ex.isolated_run(r)
            counted.append(syncs() - before)
            implied.append(5 + 1)       # five uploads, one synchronise
            alloc.allocate(r.rid, r.prompt_tokens + r.output_tokens + 2)
            r.state = State.ENCODING if r.mm_units else State.PREFILLING
        for step in range(100):
            prefill, decode, encode = _plan(reqs, left, step)
            if not (prefill or decode or encode):
                break
            waves = max((sum(q is r for q, _c in prefill)
                         for r, _c in prefill), default=0)
            before = syncs()
            ex.run_iteration(prefill, decode, encode)
            counted.append(syncs() - before)
            encodes += len(encode)
            # a forward call: five uploads, one readback
            implied.append(6 * waves + 6 * bool(decode) + len(encode) + 1)
            for r, units in encode:
                left[r.rid] -= units
                if not left[r.rid]:
                    r.state = State.PREFILLING
            for r, c in prefill:
                r.prefilled += c
                if r.prefilled >= r.prompt_tokens:
                    r.state, r.decoded = State.RUNNING, 1
            for r in decode:
                r.decoded += 1
                if r.decoded >= r.output_tokens:
                    r.state = State.FINISHED
                    alloc.free(r.rid)
                    ex.release_slot(r)
        assert all(r.state is State.FINISHED for r in reqs)
    finally:
        obs.disable()
        obs.record_function = real_rf
    return {"tokens": {r.rid: list(ex.emitted[r.rid]) for r in reqs},
            "counted": counted, "implied": implied, "encodes": encodes,
            "records": list(obs.records), "entered": _Spy.entered,
            "steps": step}


_RUNS = {}


def _run(on: bool) -> dict:
    if on not in _RUNS:
        obs.reset()
        _RUNS[on] = _drive(on)
        obs.reset()
    return _RUNS[on]


def test_off_a_span_is_one_shared_no_op():
    off = _run(False)
    assert off["records"] == [] and off["entered"] == 0
    assert obs.span("a") is obs.span("b")
    with obs.span("a"):
        pass
    assert obs.snapshot()["records"] == 0
    on = _run(True)
    assert on["entered"] == len(on["records"]) > 0


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_syncs_per_step_follow_the_plan(on):
    run = _run(on)
    assert run["counted"] == run["implied"]
    # the plan has a step of two prefill waves, encodes and decodes
    assert max(run["implied"]) >= 6 * 2 + 1 and run["steps"] > 5


def test_tracing_leaves_the_tokens_alone():
    assert _run(True)["tokens"] == _run(False)["tokens"]
    assert all(len(t) == o for (_r, _m, _p, o, _u), t in
               zip(SPECS, _run(True)["tokens"].values()))


def test_spans_nest_by_the_executors_layers():
    recs = _run(True)["records"]
    names = [r[0] for r in recs]
    parent = {i: recs[r[3]][0] if r[3] is not None else None
              for i, r in enumerate(recs)}
    for i, name in enumerate(names):
        if name in CALL:
            assert parent[i] in ("exec.prefill", "exec.decode"), (name, i)
        elif name in ("exec.prefill", "exec.decode", "exec.encode",
                      "exec.sync"):
            assert parent[i] in ("exec.iteration",
                                 "exec.admission_profile"), (name, i)
        else:
            assert name in ("exec.iteration", "exec.admission_profile")
            assert parent[i] is None
    assert names.count("exec.admission_profile") == len(SPECS)
    assert names.count("exec.iteration") == _run(True)["steps"]
    assert names.count("exec.encode") == _run(True)["encodes"] > 0
    for r in recs:
        if r[3] is not None:
            p = recs[r[3]]
            assert p[1] <= r[1] <= r[2] <= p[2]


def test_leaf_spans_cover_each_iteration():
    recs = _run(True)["records"]
    for i, (name, t0, t1, _p) in enumerate(recs):
        if name != "exec.iteration":
            continue
        leaves = sorted((r[1], r[2]) for j, r in enumerate(recs)
                        if r[0] in LEAVES and _inside(recs, j, i))
        covered, end = 0.0, t0
        for a, b in leaves:
            covered += max(0.0, b - max(a, end))
            end = max(end, b)
        assert covered >= 0.9 * (t1 - t0), (i, covered, t1 - t0)


def _inside(recs, j, i) -> bool:
    p = recs[j][3]
    while p is not None:
        if p == i:
            return True
        p = recs[p][3]
    return False


@pytest.mark.parametrize("cap", [2, 1 << 20])
def test_records_nest_and_stop_at_the_cap(monkeypatch, cap):
    monkeypatch.setattr(obs, "record_function", _Spy)
    monkeypatch.setattr(obs, "CAP", cap)
    obs.enable()
    with obs.span("outer"):
        with obs.span("inner"):
            obs.count("n", 3)
        with obs.span("second"):
            pass
    obs.count("n")
    snap = obs.snapshot()
    kept = min(cap, 3)
    assert snap == {"records": kept, "dropped": 3 - kept,
                    "counters": {"n": 4}}
    outer, inner = obs.records[:2]
    assert outer[0] == "outer" and outer[3] is None
    assert inner[0] == "inner" and inner[3] == 0
    assert outer[1] <= inner[1] <= inner[2] <= outer[2]
    obs.reset()
    assert obs.snapshot() == {"records": 0, "dropped": 0, "counters": {}}
