"""The batched paged path's captured forwards (``ModelExecutor._step``).

On the CPU a stand-in for ``torch.cuda.CUDAGraph`` drives the graph cache's
bookkeeping: one capture per call shape and replays after it, static inputs
rewritten whole, every graph dropped with the paged stores, calls above
``GRAPH_MAX_TOKENS`` eager, no capture inside ``isolated_run``'s timed
region, at most ``recompile_bound()`` graphs, the three counters, and the
kernels' launch counters as an eager run leaves them. And the admission
price that ``isolated_e2e`` reads off a shape's graph: kept from a timed
``isolated_run`` that did not capture it, reused with no run, dropped with
the graphs, never kept where no graph serves the shape.

On the card (marked ``gpu``) the same plan runs through the captured graphs
and through the eager forward for reduced qwen2-vl-2b (M-RoPE), chatglm3-6b
and phi3.5-moe (the MoE ``index`` dispatch), and must emit the same tokens
and count the same kernel launches. Run it with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_graphs.py
"""
import dataclasses

import pytest
import torch

from repro_torch import configs, obs
from repro_torch.cache import BlockAllocator
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as dec
from repro_torch.kernels import paged_prefill_attention as pre
from repro_torch.serving import executors as E
from repro_torch.serving.request import Modality, Request, State

MAX_LEN, PAGE, CHUNK, ENCODE, PAGES = 64, 16, 12, 128, 64
# (rid, modality, prompt tokens, output tokens, encoder units)
SPECS = [("t0", Modality.TEXT, 23, 12, 0), ("i1", Modality.IMAGE, 30, 10, 40),
         ("v2", Modality.VIDEO, 45, 4, 300), ("t3", Modality.TEXT, 9, 14, 0)]
COUNTERS = ("exec.graph_captures", "exec.graph_replays", "exec.graph_eager")


@pytest.fixture(autouse=True)
def _clean():
    obs.disable()
    obs.reset()
    ops.reset_launch_counts()
    yield
    obs.reset()
    ops.reset_launch_counts()


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: a replay reruns the captured
    function on the static inputs into the captured output, and, as a real
    replay runs no Python, leaves the launch counters as they were."""

    def __init__(self, fn, out, log):
        self.fn, self.out, self.log = fn, out, log
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.log.append("replay")
        before = ops.launch_counts()
        self.out.copy_(self.fn())
        ops.add_launch_counts({k: before[k] - n
                               for k, n in ops.launch_counts().items()})


class _FakeCapture:
    """Stands in for ``CudaGraphCapture``: a warm-up, then the capture."""

    def __init__(self):
        self.log, self.graphs = [], []

    def __call__(self, fn):
        fn()
        out = fn()
        self.log.append("capture")
        g = _FakeGraph(fn, out, self.log)
        self.graphs.append(g)
        return g, out


def _executor(arch="chatglm3-6b", device="cpu", graphs=True):
    cfg = configs.get_reduced(arch)
    if device == "cpu":
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    ex = E.ModelExecutor(cfg, E.ExecutorConfig(max_slots=4, max_len=MAX_LEN,
                                               page_size=PAGE),
                         device=device)
    if device == "cpu" and graphs:
        ex._capture = _FakeCapture()
    elif not graphs:
        ex._capture = None          # the eager forward, called directly
    return ex


def _counting(ex):
    """Make each forward count one launch of each paged kernel, as the
    kernels' Python wrappers do on the card (on the CPU they launch
    nothing)."""
    forward = ex._forward

    def counted(*args):
        dec.launches += 1
        pre.launches += 2
        return forward(*args)
    ex._forward = counted


def _plan(reqs, left, step):
    """(prefill work, decode requests, encode work) of one step: encode
    chunks first, then prefill chunks of the encoded prompts (t0's prompt
    as two chunks of one plan at step 0: two waves), and decode."""
    encode = [(r, min(ENCODE, left[r.rid])) for r in reqs
              if r.state is State.ENCODING]
    prefill = []
    for r in reqs:
        if r.state is not State.PREFILLING:
            continue
        rest = r.prompt_tokens - r.prefilled
        if step == 0 and r.rid == "t0":
            prefill += [(r, CHUNK), (r, rest - CHUNK)]
        else:
            prefill.append((r, min(CHUNK, rest)))
    decode = [r for r in reqs if r.state is State.RUNNING]
    return prefill, decode, encode


def _drive(ex):
    """Admission profiles, then engine-like steps to the end: the tokens
    and the decode batch sizes."""
    alloc = BlockAllocator(num_pages=PAGES, page_size=PAGE)
    ex.bind_allocator(alloc)
    reqs = [Request(rid=rid, modality=m, arrival=0.0, text_tokens=p,
                    mm_units=u, prompt_tokens=p, output_tokens=o)
            for rid, m, p, o, u in SPECS]
    left = {r.rid: r.mm_units for r in reqs}
    for r in reqs:
        ex.isolated_run(r)
        alloc.allocate(r.rid, r.prompt_tokens + r.output_tokens + 2)
        r.state = State.ENCODING if r.mm_units else State.PREFILLING
    sizes = []
    for step in range(100):
        prefill, decode, encode = _plan(reqs, left, step)
        if not (prefill or decode or encode):
            break
        ex.run_iteration(prefill, decode, encode)
        if decode:
            sizes.append(len(decode))
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
    return {r.rid: list(ex.emitted[r.rid]) for r in reqs}, sizes


def _counters():
    got = obs.snapshot()["counters"]
    return [got.get(name, 0) for name in COUNTERS]


def test_one_capture_per_shape_then_replays_and_the_same_tokens():
    eager = _executor(graphs=False)
    _counting(eager)
    want, sizes = _drive(eager)
    want_launches = ops.launch_counts()
    assert _counters() == [0, 0, 0]     # no capture machinery, no counts
    ops.reset_launch_counts()
    ex = _executor()
    _counting(ex)
    got, sizes_g = _drive(ex)
    assert got == want and sizes_g == sizes
    # a decode batch shrank inside its bucket (4 rows, then 3)
    assert 4 in sizes and 3 in sizes
    fake = ex._capture
    assert len(fake.graphs) == len(ex._graphs) == len(set(ex._graphs))
    # every shape at MAX_LEN is under the token bound: one graph per key
    assert set(ex._graphs) == ex.recompile_keys
    assert len(ex._graphs) <= ex.recompile_bound()
    calls = sum(g.replays for g in fake.graphs)
    captures, replays, eager_calls = _counters()
    assert (captures, replays, eager_calls) == (len(ex._graphs), calls, 0)
    # each graph replayed at least once, some more than once
    assert all(g.replays >= 1 for g in fake.graphs)
    assert calls > captures
    # the launch counters read as the eager run's: replays count, the
    # captures' warm-ups do not
    assert ops.launch_counts() == want_launches
    assert want_launches["paged_attention"] == calls


def _decoding(ex, n=4):
    """``n`` running requests, prompts 20.. tokens written, one token
    emitted each, on a fresh allocator bound to ``ex``."""
    alloc = BlockAllocator(num_pages=PAGES, page_size=PAGE)
    ex.bind_allocator(alloc)
    reqs = []
    for i in range(n):
        r = Request(rid=f"r{i}", modality=Modality.TEXT, arrival=0.0,
                    text_tokens=20 + i, prompt_tokens=20 + i,
                    output_tokens=4)
        r.state, r.decoded = State.RUNNING, 1
        alloc.allocate(r.rid, 40)
        ex._ctx[r.rid] = r.prompt_tokens
        ex.emitted[r.rid] = [7 + i]
        reqs.append(r)
    return reqs


def test_static_inputs_are_rewritten_whole():
    """A decode of 3 rows after one of 4 in the same bucket: row 3 of the
    static inputs is padding again (trash page, length 0, new_lens 0)."""
    ex = _executor()
    reqs = _decoding(ex)
    ex._batched_iteration([], reqs)
    (shape,) = ex._graphs
    g = ex._graphs[shape]
    tokens, positions, bt, lengths, new_lens = (a.clone() for a in g.inputs)
    assert shape[0] == 4 and shape[1] == 1
    assert int(new_lens[3]) == 1 and int(lengths[3]) == 23
    assert (bt[3] != PAGES).any()
    ex._batched_iteration([], reqs[:3])
    assert list(ex._graphs) == [shape]
    tokens, positions, bt, lengths, new_lens = g.inputs
    assert (bt[3] == PAGES).all()
    assert int(lengths[3]) == 0 and int(new_lens[3]) == 0
    assert int(tokens[3, 0]) == 0 and int(positions[3, 0]) == 0
    assert int(new_lens[:3].sum()) == 3
    assert _counters() == [1, 2, 0]


def test_a_decode_is_a_one_token_call():
    """A decode of four rows fills the same static inputs, through the same
    graph and recompile key, as ``_paged_call`` of the same rows written
    as one-token chunks, and draws the same tokens."""
    ex = _executor()
    reqs = _decoding(ex)
    rows = [(r.rid, [ex.emitted[r.rid][-1]], r.prompt_tokens + r.decoded - 1,
             ex._ctx[r.rid], 1) for r in reqs]
    ex._batched_iteration([], reqs)
    (shape,) = ex._graphs
    g = ex._graphs[shape]
    decoded = [a.clone() for a in g.inputs]
    tokens, positions, bt, lengths, new_lens = decoded
    assert shape == (4, 1, 2) and ex.recompile_keys == {shape}
    assert tokens[:, 0].tolist() == [7, 8, 9, 10]
    assert positions[:, 0].tolist() == [20, 21, 22, 23]
    assert lengths.tolist() == [20, 21, 22, 23] and new_lens.tolist() == [1] * 4
    out = ex._paged_call(rows).tolist()
    assert list(ex._graphs) == [shape] and ex.recompile_keys == {shape}
    assert all(torch.equal(a, b) for a, b in zip(decoded, g.inputs))
    assert out == [ex.emitted[r.rid][-1] for r in reqs]
    assert _counters() == [1, 2, 0]


def _claim(ex):
    ex.on_prefix_claim(Request(rid="c", modality=Modality.TEXT, arrival=0.0,
                               text_tokens=8, prompt_tokens=8,
                               output_tokens=1),
                       tokens=5, cow_src=3, cow_dst=7)


def _import(ex):
    cfg = ex.cfg        # one page of every layer's K and V, f32 on the CPU
    ex.import_page_payload(
        [2], [bytes(2 * cfg.num_layers * PAGE * cfg.num_kv_heads * cfg.hd * 4)])


STORE_ENTRIES = {
    "prefix_claim": _claim,
    "export": lambda ex: ex.export_page_payload([1]),
    "import": _import,
    "call": lambda ex: ex._paged_call([("r", [5], 0, 0, 1)]),
    "capture": lambda ex: ex._graph_for((1, 1, 1)),
}


@pytest.mark.parametrize("entry", sorted(STORE_ENTRIES))
def test_paged_stores_are_built_once(entry):
    """Each entry builds the paged stores on first use; every later entry
    uses the same ones; a new allocator geometry drops them, and the next
    use builds them at it. The packed call runs eagerly, so its forward
    is what builds them."""
    ex = _executor(graphs=entry != "call")
    built, make = [], ex._make_stores

    def counted():
        built.append(ex.allocator.num_pages)
        return make()
    ex._make_stores = counted

    def bind(pages):
        alloc = BlockAllocator(num_pages=pages, page_size=PAGE)
        alloc.allocate("r", PAGE)
        ex.bind_allocator(alloc)
    bind(PAGES)
    assert ex._stores is None
    STORE_ENTRIES[entry](ex)
    stores = ex._stores
    assert built == [PAGES] and stores is not None
    for other in sorted(STORE_ENTRIES):
        STORE_ENTRIES[other](ex)
    assert built == [PAGES] and ex.stores is stores
    bind(PAGES // 2)
    assert ex._stores is None and ex._graphs == {}
    STORE_ENTRIES[entry](ex)
    assert built == [PAGES, PAGES // 2]
    assert ex.stores[0]["b0"].pages_per_layer == PAGES // 2 + 1


def test_every_graph_is_dropped_with_the_stores():
    ex = _executor()
    _drive(ex)
    assert ex._graphs and ex._stores is not None
    # the same geometry keeps the stores, and so the graphs
    ex.bind_allocator(BlockAllocator(num_pages=PAGES, page_size=PAGE))
    assert ex._graphs and ex._stores is not None
    ex.bind_allocator(BlockAllocator(num_pages=PAGES // 2, page_size=PAGE))
    assert ex._graphs == {} and ex._stores is None
    captures = _counters()[0]
    r = Request(rid="again", modality=Modality.TEXT, arrival=0.0,
                text_tokens=9, prompt_tokens=9, output_tokens=2)
    ex.isolated_run(r)
    (g,) = ex._graphs.values()
    assert _counters()[0] == captures + 1
    # captured afresh, over the new stores: the warm-up's table is the new
    # trash page
    assert ex._capture.graphs[-1] is g.graph and ex._stores is not None


def test_calls_above_the_token_bound_run_eagerly(monkeypatch):
    monkeypatch.setattr(E, "GRAPH_MAX_TOKENS", 8)
    want, _ = _drive(_executor(graphs=False))
    obs.reset()
    ex = _executor()
    got, _ = _drive(ex)
    assert got == want
    assert ex._graphs and all(B * C <= 8 for B, C, _p in ex._graphs)
    big = {s for s in ex.recompile_keys if s[0] * s[1] > 8}
    assert big and not big & set(ex._graphs)
    captures, replays, eager_calls = _counters()
    assert captures == len(ex._graphs) and replays > 0 and eager_calls > 0
    # an eager executor counts no eager calls: only a capturing one does
    obs.reset()
    _drive(_executor(graphs=False))
    assert _counters() == [0, 0, 0]


def test_isolated_run_times_no_capture(monkeypatch):
    ex = _executor()
    log = ex._capture.log
    clock = E.time.perf_counter

    def logged():
        log.append("clock")
        return clock()
    monkeypatch.setattr(E.time, "perf_counter", logged)
    ex.bind_allocator(BlockAllocator(num_pages=PAGES, page_size=PAGE))
    for rid, prompt in (("a", 23), ("b", 20), ("c", 45)):
        del log[:]
        ex.isolated_run(Request(rid=rid, modality=Modality.TEXT, arrival=0.0,
                                text_tokens=prompt, prompt_tokens=prompt,
                                output_tokens=2))
        first, last = log.index("clock"), len(log) - 1 - log[::-1].index(
            "clock")
        assert log[first:last + 1] == ["clock", "replay", "clock"], log
        # "b" has "a"'s shape: no capture at all
        assert log[:first] == ([] if rid == "b" else ["capture"]), log


def _text(rid, prompt, out=2):
    return Request(rid=rid, modality=Modality.TEXT, arrival=0.0,
                   text_tokens=prompt, prompt_tokens=prompt,
                   output_tokens=out)


def _timing(ex):
    """The rids ``isolated_e2e`` times: it looks ``isolated_run`` up on the
    executor, as the benchmark's trace wrapper replaces it there."""
    timed, run = [], ex.isolated_run

    def spy(req):
        timed.append(req.rid)
        return run(req)
    ex.isolated_run = spy
    return timed


def _prices():
    got = obs.snapshot()["counters"]
    return got.get("exec.price_reused", 0), got.get("exec.price_timed", 0)


def test_a_kept_shape_prices_the_next_arrival_with_no_run():
    ex = _executor()
    ex.bind_allocator(BlockAllocator(num_pages=PAGES, page_size=PAGE))
    timed = _timing(ex)
    # 23, 20 and 30 tokens take one call shape, (1, 32, 2)
    slo = [ex.isolated_e2e(_text(rid, p, out))
           for rid, p, out in (("a", 23, 2), ("b", 20, 3), ("c", 30, 5))]
    (shape,) = ex._graphs
    g = ex._graphs[shape]
    assert shape == (1, 32, 2)
    assert timed == ["a", "b"] and g.graph.replays == 2
    assert g.price is not None and g.price > 0
    # b's timed call is the kept price; c pays it with no run
    assert slo[1:] == [g.price * (1 + 0.1 * out) for out in (3, 5)]
    assert _prices() == (1, 2)


def test_the_first_replay_after_a_capture_is_not_kept():
    ex = _executor()
    alloc = BlockAllocator(num_pages=PAGES, page_size=PAGE)
    ex.bind_allocator(alloc)
    ex.isolated_run(_text("a", 23))
    (g,) = ex._graphs.values()
    assert g.graph.replays == 1 and g.price is None
    ex.isolated_run(_text("b", 20))
    assert g.graph.replays == 2 and g.price is not None
    # a shape a serving step captured: the profile's replay is its second
    r = _text("s", 9)
    alloc.allocate(r.rid, 16)
    r.state = State.PREFILLING
    ex.run_iteration([(r, 9)], [], [])
    served = ex._graphs[(1, 16, 1)]
    assert served.graph.replays == 1 and served.price is None
    ex.isolated_run(_text("c", 12))
    assert served.graph.replays == 2 and served.price is not None


@pytest.mark.parametrize("case", ["above the bound", "no graphs", "legacy"])
def test_these_time_every_arrival(case, monkeypatch):
    if case == "above the bound":
        monkeypatch.setattr(E, "GRAPH_MAX_TOKENS", 16)
    if case == "legacy":
        cfg = dataclasses.replace(configs.get_reduced("chatglm3-6b"),
                                  dtype=torch.float32)
        ex = E.ModelExecutor(cfg, E.ExecutorConfig(
            max_slots=4, max_len=MAX_LEN, page_size=PAGE, legacy=True),
            device="cpu")
        assert ex.legacy and ex._capture is None
    else:
        ex = _executor(graphs=case != "no graphs")
    ex.bind_allocator(BlockAllocator(num_pages=PAGES, page_size=PAGE))
    timed = _timing(ex)
    rids = ["a", "b", "c", "d"]
    for rid, prompt in zip(rids, (23, 20, 30, 25)):
        ex.isolated_e2e(_text(rid, prompt))
    assert timed == rids and _prices() == (0, 4)
    assert ex._graphs == {}


def test_a_hit_borrows_no_pages_with_the_pool_full():
    ex = _executor()
    alloc = BlockAllocator(num_pages=PAGES, page_size=PAGE)
    ex.bind_allocator(alloc)
    for rid in ("a", "b"):
        ex.isolated_e2e(_text(rid, 23))
    (g,) = ex._graphs.values()
    alloc.allocate("hog", PAGES * PAGE)
    assert alloc.available_pages == 0
    borrowed, allocate = [], alloc.allocate
    alloc.allocate = lambda rid, n: borrowed.append(rid) or allocate(rid, n)
    timed = _timing(ex)
    syncs = obs.snapshot()["counters"].get("exec.syncs", 0)
    assert ex.isolated_e2e(_text("c", 30)) == g.price * (1 + 0.1 * 2)
    assert timed == [] and borrowed == [] and alloc.available_pages == 0
    assert obs.snapshot()["counters"].get("exec.syncs", 0) == syncs
    assert g.graph.replays == 2


def test_a_new_geometry_drops_the_kept_prices():
    ex = _executor()
    ex.bind_allocator(BlockAllocator(num_pages=PAGES, page_size=PAGE))
    timed = _timing(ex)
    for rid in ("a", "b"):
        ex.isolated_e2e(_text(rid, 23))
    (g,) = ex._graphs.values()
    assert g.price is not None
    # the same geometry keeps the graphs, and so their prices
    ex.bind_allocator(BlockAllocator(num_pages=PAGES, page_size=PAGE))
    ex.isolated_e2e(_text("c", 30))
    assert timed == ["a", "b"]
    ex.bind_allocator(BlockAllocator(num_pages=PAGES // 2, page_size=PAGE))
    assert ex._graphs == {}
    for rid in ("d", "e", "f"):
        ex.isolated_e2e(_text(rid, 23))
    # captured afresh (d), kept again (e), reused (f)
    assert timed == ["a", "b", "d", "e"]
    assert ex._graphs[(1, 32, 2)] is not g


def test_the_counters_count_reused_and_timed_prices():
    ex = _executor()
    ex.bind_allocator(BlockAllocator(num_pages=PAGES, page_size=PAGE))
    timed = _timing(ex)
    # shapes (1, 32, 2) five times, (1, 16, 1) three times, (1, 64, 4) once
    prompts = (23, 9, 20, 12, 30, 25, 45, 15, 28)
    reqs = [_text(f"r{i}", p) for i, p in enumerate(prompts)]
    for r in reqs:
        ex.isolated_e2e(r)
    reused, n_timed = _prices()
    assert n_timed == len(timed) == 5 and reused == 4
    # a repriced request reads its own memo: neither counter moves
    for r in reqs:
        r.cached_prefix_tokens = 4
        ex.isolated_e2e(r)
    assert _prices() == (reused, n_timed) and len(timed) == 5


def test_an_engine_emits_the_same_tokens_with_kept_prices():
    from repro_torch.core.classifier import NaiveClassifier
    from repro_torch.core.scheduler import make_policy
    from repro_torch.serving.engine import Engine, EngineConfig
    specs = ((23, 6), (20, 4), (9, 5), (30, 7), (25, 3), (12, 8), (28, 4))
    runs = {}
    for reuse in (True, False):
        obs.reset()
        ex = _executor()
        if not reuse:
            ex._kept_price = lambda req: None     # every arrival timed
        timed = _timing(ex)
        reqs = [_text(f"r{i}", p, o) for i, (p, o) in enumerate(specs)]
        eng = Engine(make_policy("tcm"), ex, NaiveClassifier(),
                     EngineConfig(token_budget=CHUNK, kv_pages=PAGES,
                                  page_size=PAGE))
        eng.run(reqs, max_iters=500)
        assert len(eng.finished) == len(reqs)
        runs[reuse] = ({r.rid: list(ex.emitted[r.rid]) for r in reqs},
                       _prices(), len(timed))
    (tokens, prices, n_timed), (want, prices_t, n_timed_t) = \
        runs[True], runs[False]
    assert tokens == want
    assert all(len(t) == o for t, (_p, o) in zip(want.values(), specs))
    assert prices == (3, 4) and n_timed == 4
    assert prices_t == (0, len(specs)) and n_timed_t == len(specs)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "chatglm3-6b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_cuda_graphs_emit_the_eager_tokens_and_launches(arch):
    """The plan through the captured graphs and through the eager forward
    on the card: the same tokens and the same kernel launch counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    eager = _executor(arch, "cuda", graphs=False)
    want, sizes = _drive(eager)
    torch.cuda.synchronize()
    want_launches = ops.launch_counts()
    ops.reset_launch_counts()
    obs.reset()
    ex = _executor(arch, "cuda")
    assert isinstance(ex._capture, E.CudaGraphCapture)
    got, sizes_g = _drive(ex)
    torch.cuda.synchronize()
    assert 4 in sizes and 3 in sizes and sizes_g == sizes
    assert got == want
    assert ops.launch_counts() == want_launches
    assert want_launches["paged_attention"] > 0
    assert want_launches["paged_prefill_attention"] > 0
    captures, replays, eager_calls = _counters()
    assert captures == len(ex._graphs) > 0 and replays > captures
    assert eager_calls == 0
    assert len(ex._graphs) <= ex.recompile_bound()
