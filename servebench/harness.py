"""One run of one cell: build the stack, drive the open loop for the window,
stamp every token on the wall clock, check the outputs, reduce the metrics.

The window drives ``repro_torch.serving.engine.Engine.step`` over the
batched paged path of ``ModelExecutor``, assembled as
``repro_torch.launch.serve.build_stack`` assembles it (warm-up, profile,
estimator, classifier, policy ``tcm``), with weights the benchmark makes
from the seed.

The loop is open: a request is handed to ``step`` once it is due on the
wall clock, whatever the engine is doing. Before each step the engine's
clock is set to the wall-clock seconds since the window opened (never
backwards), so aging and ingest run in real seconds. Every time a metric
reads is stamped here, after ``step`` returns: a request's first token and
each later one, from its due time. The engine's own timestamps feed
nothing.
"""
from __future__ import annotations

import contextlib
import gc
import math
import os
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from servebench import cells, generator, prompts, weights


@dataclass
class Served:
    """What one request saw, on the harness's clock (seconds since the
    window opened)."""
    item: generator.Item
    req: object = None                  # the program's Request
    token_times: list = field(default_factory=list)
    failed: bool = False
    tokens: list | None = None          # served ids, read after the run

    @property
    def due(self) -> float:
        return self.item.arrival


@dataclass
class Step:
    """One ``run_iteration`` call, as the harness saw it (trace runs)."""
    t: float
    seconds: float
    prefill: list                       # (start, n, wave) per chunk
    decode: list                        # keys each decode row sees
    emitting: int
    profiled: bool


@dataclass
class Run:
    """Everything a metric reader may read."""
    cell: dict
    config: dict
    model: dict                         # the model's sizes, as run
    seconds: float
    drain: bool
    served: list
    traffic: dict = field(default_factory=dict)  # the mix file
    setup_s: float = 0.0
    opened: float = 0.0                 # perf_counter() at the window's open
    close: float = 0.0                  # when the window closed
    traced_from: float = math.inf       # when the profiler opened, if it did
    end: float = 0.0                    # when the drain stopped
    drain_cap_s: float = 0.0
    # trace runs only
    steps: list = field(default_factory=list)
    engine_steps: list = field(default_factory=list)  # (t, host s outside)
    admissions: list = field(default_factory=list)    # (t, s, n, profiled)
    trace: dict | None = None

    def ttft(self, s: Served) -> float | None:
        """Wall-clock TTFT from the due time. In a cell that drains, a
        request with no first token (refused, failed, or none by the
        drain's cap) is taken to when the drain stopped."""
        if s.token_times:
            return s.token_times[0] - s.due
        return self.end - s.due if self.drain else None

    def untraced(self) -> list:
        """The requests due before the profiler opened (all of them in a
        run without one): what the host-clock readers of a traced run
        read, so the profiler's own cost stays out of them."""
        return [s for s in self.served if s.due < self.traced_from]


class Tracer:
    """``torch.profiler`` over a steady sub-window, and host annotations
    around the calls into each layer (only in trace runs)."""

    def __init__(self, torch, start: float, length: float, cuda: bool):
        self.torch = torch
        self.cuda = cuda
        self.start, self.length = start, length
        self.prof = None
        self.on = False
        self.window_s = 0.0
        self._t0 = 0.0
        self.opened_at = math.inf

    def tick(self, now: float) -> None:
        from torch.profiler import ProfilerActivity, profile
        if not self.on and self.prof is None and now >= self.start:
            self.opened_at = now
            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
            self.on = True
            self._t0 = time.perf_counter()
        elif self.on and time.perf_counter() - self._t0 >= self.length:
            self.finish()

    def finish(self) -> None:
        if self.on:
            if self.cuda:
                self.torch.cuda.synchronize()
            self.window_s = time.perf_counter() - self._t0
            self.prof.stop()
            self.on = False

    def span(self, name: str):
        if self.on:
            return self.torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def events(self) -> list:
        """The trace's events (chrome-trace dicts)."""
        import json
        if self.prof is None:
            return []
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f).get("traceEvents", [])


def reduce_trace(events: list, window_s: float) -> dict:
    """Device busy time, kernel seconds by name, and idle gaps labelled by
    the innermost host annotation (``sb.*``) around each gap."""
    dev = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                 for e in events
                 if e.get("ph") == "X" and e.get("cat") in
                 ("kernel", "gpu_memcpy", "gpu_memset"))
    kernels: dict[str, float] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0.0) + \
                e.get("dur", 0) * 1e-6
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                   for e in events
                   if e.get("cat") == "user_annotation"
                   and str(e.get("name", "")).startswith("sb."))
    busy, gaps = 0.0, []
    if dev:
        lo, hi = dev[0][0], dev[0][1]
        for a, b, _n in dev[1:]:
            if a > hi:
                busy += hi - lo
                gaps.append((hi, a))
                lo, hi = a, b
            else:
                hi = max(hi, b)
        busy += hi - lo
    idle: dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        label = "untraced host"
        width = math.inf
        for s0, s1, name in spans:
            if s0 <= mid <= s1 and s1 - s0 < width:
                label, width = name, s1 - s0
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    return {"busy_s": busy * 1e-6, "window_s": window_s,
            "kernels": kernels, "idle": idle}


def short_name(kernel: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    parameter list, at most 120 characters."""
    name = kernel.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0][:120]


def _model_config(torch, cfg_file: dict):
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**cfg_file["model"], dtype=torch.bfloat16)


def reference_config(cfg_file: dict) -> dict:
    """The sizes the reference reads: the model's, and the reference's own
    published details (M-RoPE sections)."""
    extra = {k: v for k, v in cfg_file["reference"].items() if k != "module"}
    return dict(cfg_file["model"], **extra)


def to_request(it: generator.Item):
    from repro_torch.serving.request import Modality, Request
    return Request(rid=it.rid, modality=Modality(it.modality),
                   arrival=it.arrival, text_tokens=it.text_tokens,
                   mm_units=it.mm_units, output_tokens=it.output_tokens,
                   prompt_tokens=it.prompt_tokens, mm_hash=it.mm_hash,
                   shared_prefix_id=it.shared_prefix_id,
                   shared_prefix_tokens=it.shared_prefix_tokens,
                   tenant=it.tenant)


def build(torch, cfg_file: dict, traffic: dict, seed: int, device,
          t_start: float, root: Path = cells.ROOT):
    """(executor, classifier, engine_cfg, setup parts): the
    served stack, as ``build_stack`` assembles it, with the benchmark's
    weights. Then a short serve of the mix's own sizes through the whole
    path, so the window meets no first call."""
    from repro_torch.core.classifier import SmartClassifier
    from repro_torch.core.estimator import ImpactEstimator
    from repro_torch.core.profiler import WorkloadProfiler
    from repro_torch.launch.serve import warm_up
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.executors import ExecutorConfig, ModelExecutor
    from repro_torch.serving.workload import profiling_workload

    parts = {}
    t = time.perf_counter()
    parts["process"] = t - t_start
    ref = cells.reference(root, cfg_file)
    cfg = _model_config(torch, cfg_file)
    srv = cfg_file["serving"]
    flat = weights.make(ref.layout(reference_config(cfg_file)), seed,
                        device)
    exec_cfg = ExecutorConfig(max_slots=srv["max_slots"],
                              max_len=srv["max_len"],
                              page_size=srv["page_size"],
                              num_pages=srv["kv_pages"]).resolved()
    executor = ModelExecutor(cfg, exec_cfg, device=device,
                             params=weights.tree(flat))
    del flat
    _sync(torch, device)
    parts["weights"] = time.perf_counter() - t
    t = time.perf_counter()
    warm_up(executor)                   # makes the KV pool, builds kernels
    _sync(torch, device)
    parts["kv_pool_warm_up"] = time.perf_counter() - t
    t = time.perf_counter()
    profile = WorkloadProfiler(executor, cfg.name).build(
        profiling_workload(n_per_modality=8))
    parts["profile"] = time.perf_counter() - t
    t = time.perf_counter()
    est = ImpactEstimator.train(profile)
    parts["estimator"] = time.perf_counter() - t
    t = time.perf_counter()
    classifier = SmartClassifier.train(est, profile)
    parts["classifier"] = time.perf_counter() - t
    engine_cfg = EngineConfig(token_budget=srv["token_budget"],
                              slo_scale=srv["slo_scale"],
                              kv_pages=srv["kv_pages"],
                              page_size=srv["page_size"])
    t = time.perf_counter()
    _warm_serve(executor, classifier, engine_cfg, srv, traffic)
    _sync(torch, device)
    parts["warm_serve"] = time.perf_counter() - t
    return executor, classifier, engine_cfg, parts


def _sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _warm_serve(executor, classifier, engine_cfg, srv, traffic) -> None:
    """Serve ``warm_requests`` of the mix's sizes (from its base seed, all
    due at once, a few tokens each) through a throwaway engine: the call
    shapes and allocator blocks of the window's steps, made in set-up."""
    from repro_torch.core.scheduler import make_policy
    from repro_torch.serving.engine import Engine
    n = int(traffic.get("warm_requests", 16))
    if n <= 0:
        return
    params = dict(traffic["generator"], seed=int(traffic["base_seed"]) + 1,
                  num_requests=n)
    items = generator.generate(generator.Mix.from_dict(params))
    reqs = []
    for it in items:
        it.rid = f"__warm__{it.rid}"
        it.arrival = 0.0
        it.output_tokens = min(it.output_tokens, 4)
        if it.mm_hash:
            it.mm_hash = f"__warm__{it.mm_hash}"
        reqs.append(to_request(it))
    engine = Engine(make_policy(srv["policy"]), executor, classifier,
                    engine_cfg)
    engine.run(reqs, max_iters=20 * n + 200)
    for r in reqs:
        executor.evict_request(r.rid)


def drive(torch, run: Run, executor, classifier, engine_cfg, *,
          trace: bool, trace_start: float, trace_len: float):
    """The window and the drain. Fills ``run``'s stamps, and in a trace run
    its step records and the profiler's reduction."""
    from repro_torch.core.scheduler import make_policy
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import TERMINAL_STATES, State

    srv = run.config["serving"]
    engine = Engine(make_policy(srv["policy"]), executor, classifier,
                    engine_cfg)
    served = run.served
    tracer = (Tracer(torch, trace_start, trace_len,
                     executor.device.type == "cuda") if trace else None)
    span = tracer.span if trace else (lambda _name: contextlib.nullcontext())
    clock = time.perf_counter
    max_len = srv["max_len"]
    steps, admissions = run.steps, run.admissions
    iter_s = [0.0]                      # run_iteration + isolated_run in
    #                                     the current engine step

    if trace:
        orig_iter = executor.run_iteration
        orig_iso = executor.isolated_run

        def run_iteration(prefill_work, decode_reqs, encode_work):
            pre, est, waves = [], {}, {}
            emitting = 0
            for req, chunk in prefill_work:
                if req not in engine.prefilling:
                    continue            # preempted later in the plan
                start = est.get(req.rid, req.prefilled)
                est[req.rid] = start + chunk
                n = min(chunk, max_len - start - 4)
                if n <= 0:
                    continue
                wave = waves.get(req.rid, -1) + 1
                waves[req.rid] = wave
                pre.append((start, n, wave))
                if start + chunk >= req.prompt_tokens:
                    emitting += 1
            dec = [r.prompt_tokens + r.decoded for r in decode_reqs
                   if r in engine.running]
            t0 = clock()
            with span("sb.run_iteration"):
                out = orig_iter(prefill_work, decode_reqs, encode_work)
            dt = clock() - t0
            iter_s[0] += dt
            steps.append(Step(t0 - w0, dt, pre, dec, emitting + len(dec),
                              tracer.on))
            return out

        def isolated_run(req):
            t0 = clock()
            with span("sb.admission_profile"):
                out = orig_iso(req)
            dt = clock() - t0
            iter_s[0] += dt
            admissions.append((t0 - w0, dt,
                               min(req.prompt_tokens, max_len - 8),
                               tracer.on))
            return out

        executor.run_iteration = run_iteration
        executor.isolated_run = isolated_run

    items = [s.item for s in served]
    # what set-up made stays out of the collector's way in the window
    gc.collect()
    gc.freeze()
    nxt = 0
    pending: list = []
    live: list[Served] = []
    close = run.seconds
    cap = close + run.drain_cap_s
    w0 = run.opened = clock()
    try:
        while True:
            now = clock() - w0
            if tracer is not None:
                tracer.tick(now)
            if now >= close:
                if not run.drain and not (tracer and tracer.on):
                    break               # (a trace runs its full length)
                waiting = [s for s in served[:nxt]
                           if not s.token_times and not s.failed]
                if nxt == len(served) and not waiting and not pending:
                    break
                if now >= cap:
                    break
            while nxt < len(items) and items[nxt].arrival <= now:
                s = served[nxt]
                s.req = to_request(items[nxt])
                pending.append(s.req)
                live.append(s)
                nxt += 1
            if engine.idle and not pending:
                due = items[nxt].arrival if nxt < len(items) else close
                if now >= close:
                    break               # nothing left to drain
                wait = min(due, close) - now
                if wait > 0:
                    with span("sb.idle"):
                        time.sleep(min(wait, 0.05))
                continue
            engine.now = max(engine.now, now)
            iter_s[0] = 0.0
            t0 = clock()
            with span("sb.step"):
                pending = engine.step(pending)
            t1 = clock()
            if trace:
                run.engine_steps.append((t0 - w0, (t1 - t0) - iter_s[0]))
            stamp = t1 - w0
            counts = run.drain or stamp <= close
            keep = []
            for s in live:
                r = s.req
                if counts:
                    while len(s.token_times) < min(r.decoded,
                                                   r.output_tokens):
                        s.token_times.append(stamp)
                if r.state in TERMINAL_STATES:
                    if r.state is not State.FINISHED:
                        s.failed = True
                    continue
                keep.append(s)
            live = keep
    finally:
        gc.unfreeze()
        if tracer is not None:
            tracer.finish()
        if trace:
            executor.run_iteration = orig_iter
            executor.isolated_run = orig_iso
    run.close = close
    run.end = min(clock() - w0, cap) if run.drain else close
    for s in served:
        if run.drain and s.req is not None and not s.token_times:
            s.failed = True             # no first token by the cap
    if trace:
        run.traced_from = tracer.opened_at
        run.trace = reduce_trace(tracer.events(), tracer.window_s)
    return engine


def served_tokens(executor, run: Run) -> None:
    """Read the program's outputs (to be judged) before it is freed."""
    for s in run.served:
        if s.req is not None and s.req.state.value == "finished":
            s.tokens = list(executor.emitted.get(s.req.rid, []))


def sample(run: Run, seed: int, want_tokens: int, max_requests: int,
           max_reference_tokens: int) -> list[Served]:
    """Requests the check compares: the longest finished one, then others
    drawn from the seed, until ``want_tokens`` served tokens."""
    done = [s for s in run.served if s.tokens]
    if not done:
        return []
    size = lambda s: s.item.prompt_tokens + len(s.tokens)  # noqa: E731
    longest = max(done, key=size)
    chosen, toks, ref = [longest], len(longest.tokens), size(longest)
    rng = np.random.default_rng(int(seed) ^ 0x5EED)
    for i in rng.permutation(len(done)):
        s = done[int(i)]
        if toks >= want_tokens or len(chosen) >= max_requests:
            break
        if s is longest or ref + size(s) > max_reference_tokens:
            continue
        chosen.append(s)
        toks += len(s.tokens)
        ref += size(s)
    return chosen


def gaps(torch, ref, rcfg: dict, flat: dict, chosen: list[Served],
         precision: str = "f32") -> list[float]:
    """Per sampled request, the widest gap by which a served token's
    reference logit lies below the reference's best. With ``precision``
    "fp8" (the control) the token read is the one the fp8 forward puts
    first, at the same positions."""
    out = []
    dev = flat["embed"].device
    for s in chosen:
        it = s.item
        chunks = prompts.content_chunks(
            it.rid, it.prompt_tokens, it.mm_units, it.mm_hash,
            it.shared_prefix_id, it.shared_prefix_tokens)
        p = prompts.prompt_tokens(it.rid, chunks, rcfg["vocab_size"])
        seq = torch.from_numpy(np.concatenate(
            [p, np.asarray(s.tokens[:-1], np.int64)])).to(dev)
        rows = torch.arange(len(p) - 1, len(p) - 1 + len(s.tokens),
                            device=dev)
        base = ref.logits(flat, rcfg, seq, rows)
        if precision == "f32":
            pick = torch.tensor(s.tokens, device=dev)
        else:
            pick = ref.logits(flat, rcfg, seq, rows,
                              precision=precision).argmax(-1)
        best = base.max(-1).values
        got = base.gather(1, pick[:, None])[:, 0]
        out.append(float((best - got).max()))
        del base
    return out


def card_line() -> str:
    import subprocess
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi gave nothing ({out.stderr.strip()})"
