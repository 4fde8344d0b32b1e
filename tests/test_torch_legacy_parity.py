"""The JAX package's executor-parity suite, held against the port on the
CPU: the scripted schedules of tests/test_batched_executor.py (random,
over-window, page-boundary), the prefix cache on vs off vs ``real-legacy``
and the copy-on-write page copy of tests/test_prefix_cache.py, and the
constructor errors of tests/test_executor_config.py. Reduced configs in
their own dtype (bf16), at the executor's default attention route
("auto": the gather path on the CPU), where the batched paged path and
the dense-slot oracle share their attention numerics (``mha``) and so
emit the same greedy tokens, as the reference promises. Plus the batched
path against the dense-slot path on every reduced arch of the paged
protocol, and the route itself: the dense-slot forward attends through
``layers.mha`` at "gather" and through ``kops.prefill_attention`` at
"kernel"."""
import dataclasses
import itertools

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.cache import BlockAllocator
from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.kernels import ops as kops
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.serving.executors import ExecutorConfig, ModelExecutor
from repro_torch.serving.request import Modality, Request, State

ARCH = "chatglm3-6b"
# every reduced arch transformer.paged_supported takes (checked below)
PAGED_ARCHS = ["chatglm3-6b", "qwen2-vl-2b", "deepseek-coder-33b",
               "qwen1.5-110b", "phi3.5-moe-42b-a6.6b", "grok-1-314b"]
PAGE = 16

# ---------------- executor pair + scripted schedule --------------------------

_EXECUTORS = {}
# each random schedule names its requests anew, so each draws new prompt
# streams (a request's name seeds its stream), as in the reference
_RIDS = itertools.count(1)


def _executor(legacy: bool, arch: str = ARCH) -> ModelExecutor:
    """A batched or dense-slot executor of the reduced ``arch`` (bf16,
    seed 0: both draw the same weights), kept across tests as the
    reference keeps its pair."""
    if (arch, legacy) not in _EXECUTORS:
        _EXECUTORS[arch, legacy] = ModelExecutor(
            get_reduced(arch),
            ExecutorConfig(max_slots=8, max_len=256, legacy=legacy),
            device="cpu")
    return _EXECUTORS[arch, legacy]


def _drive(ex: ModelExecutor, specs, chunk: int, preempt_at: int,
           victim_idx: int, tag: str):
    """Scripted engine-like schedule (``_drive`` of
    tests/test_batched_executor.py): chunked prefill + fused decode with
    one recompute-style preemption; returns emitted tokens per request.
    The requests are named ``tag`` and their index, which seeds their
    prompt streams."""
    alloc = BlockAllocator(num_pages=ex.allocator.num_pages, page_size=PAGE)
    ex.bind_allocator(alloc)
    reqs = [Request(rid=f"{tag}{i}", modality=Modality.TEXT, arrival=0.0,
                    text_tokens=p, prompt_tokens=p, output_tokens=o)
            for i, (p, o) in enumerate(specs)]
    for r in reqs:
        alloc.allocate(r.rid, r.prompt_tokens + r.output_tokens + 2)
        r.state = State.PREFILLING
    preempted_once = False
    for it in range(200):
        active = [r for r in reqs if r.state in (State.PREFILLING,
                                                 State.RUNNING)]
        if not active:
            break
        if it == preempt_at and not preempted_once:
            v = active[victim_idx % len(active)]
            alloc.free(v.rid)             # engine recompute-style eviction
            v.state = State.PREEMPTED
            ex.release_slot(v)
            v.prefilled = 0
            # immediate re-admission next iteration
            alloc.allocate(v.rid, v.prompt_tokens + v.output_tokens + 2)
            v.state = State.PREFILLING
            preempted_once = True
            continue
        prefill = [(r, min(chunk, r.prompt_tokens - r.prefilled))
                   for r in reqs if r.state is State.PREFILLING]
        decode = [r for r in reqs if r.state is State.RUNNING]
        ex.run_iteration(prefill, decode, [])
        for r, c in prefill:
            r.prefilled += c
            if r.prefilled >= r.prompt_tokens:
                r.state = State.RUNNING
                r.decoded = 1
        for r in decode:
            r.decoded += 1
            if r.decoded >= r.output_tokens:
                r.state = State.FINISHED
                alloc.free(r.rid)
                ex.release_slot(r)
    emitted = {}
    for i, r in enumerate(reqs):
        emitted[i] = list(ex.emitted.get(r.rid, []))
        ex.release_slot(r)      # drop leftover state between examples
        ex.emitted.pop(r.rid, None)
        ex._prompt_cache.pop(r.rid, None)
    return emitted


def _pair(specs, chunk, preempt_at, victim, tag, arch=ARCH):
    """(batched tokens, dense-slot tokens) of one scripted schedule."""
    return tuple(_drive(_executor(legacy, arch), specs, chunk, preempt_at,
                        victim, tag) for legacy in (False, True))


@settings(max_examples=4, deadline=None, derandomize=True)
@given(p1=st.integers(5, 40), p2=st.integers(5, 40), p3=st.integers(5, 40),
       out=st.integers(2, 5), chunk=st.integers(4, 24),
       preempt_at=st.integers(0, 6), victim=st.integers(0, 2))
def test_batched_matches_legacy_under_random_schedules(
        p1, p2, p3, out, chunk, preempt_at, victim):
    """Identical scripted schedules (ragged chunked prefill, fused decode,
    one mid-flight preemption) emit identical greedy tokens on the batched
    and the dense-slot path."""
    specs = [(p1, out), (p2, out + 1), (p3, out)]
    got_b, got_l = _pair(specs, chunk, preempt_at, victim,
                         f"pp{next(_RIDS)}-")
    assert got_b == got_l
    assert all(len(v) >= 1 for v in got_b.values())


def test_over_window_prompts_emit_and_decode_with_parity():
    """Prompts past the context window: the first token comes at the last
    in-window chunk and the decodes still run (clamped writes), with the
    same tokens on both paths."""
    specs = [(300, 3), (270, 2)]
    got_b, got_l = _pair(specs, 64, 999, 0, "ow")
    assert got_b == got_l
    assert all(len(v) == specs[i][1] for i, v in got_b.items())


def test_page_boundary_prompts_match():
    """Prompts that fill their pages exactly: the decode write lands on a
    fresh page."""
    got_b, got_l = _pair([(16, 4), (32, 3), (64, 3), (41, 3)], 16, 999, 0,
                         "pb")
    assert got_b == got_l


def test_paged_archs_are_the_paged_protocol():
    paged = {get_reduced(a).name for a in ARCH_IDS
             if T.paged_supported(get_reduced(a))}
    assert paged == set(PAGED_ARCHS)


@pytest.mark.parametrize("arch", PAGED_ARCHS)
def test_batched_matches_legacy_on_every_paged_arch(arch):
    """The scripted schedule (a ragged batch, a page-boundary prompt, one
    preemption) on each reduced arch of the paged protocol: M-RoPE, GQA
    groups, MoE routing and grok-1's softcap all emit the same tokens on
    both paths."""
    specs = [(23, 4), (16, 3), (37, 5)]
    got_b, got_l = _pair(specs, 12, 3, 1, "arch", arch)
    assert got_b == got_l
    assert [len(got_b[i]) for i in range(len(specs))] == \
        [o for _, o in specs]


# ---------------- the dense-slot route ---------------------------------------

@pytest.mark.parametrize("impl,used,unused", [
    ("gather", "mha", "prefill_attention"),
    ("kernel", "prefill_attention", "mha")])
def test_dense_slot_path_follows_the_attention_route(monkeypatch, impl, used,
                                                     unused):
    """The dense-slot forward (isolated run, chunked prefill and decode)
    attends through ``layers.mha`` at "gather" and through the dense
    kernel's wrapper at "kernel" (its plain version on the CPU, where the
    launch counters do not count), never through the other."""
    calls = {"mha": 0, "prefill_attention": 0}

    def counting(name, fn):
        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return call
    monkeypatch.setattr(layers, "mha", counting("mha", layers.mha))
    monkeypatch.setattr(kops, "prefill_attention",
                        counting("prefill_attention", kops.prefill_attention))
    ex = ModelExecutor(get_reduced(ARCH), ExecutorConfig(
        max_slots=2, max_len=64, legacy=True, attn_impl=impl), device="cpu")
    assert ex.legacy and ex.attn_impl == impl
    req = Request(rid="route", modality=Modality.TEXT, arrival=0.0,
                  text_tokens=20, prompt_tokens=20, output_tokens=3)
    ex.isolated_run(req)
    ex.allocator.allocate(req.rid, 24)
    req.state = State.PREFILLING
    ex.run_iteration([(req, 12)], [], [])
    req.prefilled = 12
    ex.run_iteration([(req, 8)], [], [])
    req.prefilled, req.decoded, req.state = 20, 1, State.RUNNING
    ex.run_iteration([], [req], [])
    assert len(ex.emitted[req.rid]) == 2
    assert calls[used] > 0 and calls[unused] == 0


# ---------------- prefix cache on / off / legacy -----------------------------

def _prefix_mix():
    """The duplicate- and shared-prefix-heavy mini mix of
    benchmarks/prefix_cache.py's ``measure_real_parity``."""
    from repro_torch.serving.workload import WorkloadConfig
    return WorkloadConfig(mix="ML", rate=50.0, num_requests=10, seed=7,
                          out_tokens_log_mu=1.8, out_tokens_log_sigma=0.3,
                          text_tokens_log_mu=3.2, text_tokens_log_sigma=0.5,
                          video_frames_min=1, video_frames_max=2,
                          image_patches=32, video_patches_per_frame=16,
                          duplicate_prob=0.6, shared_prefix_prob=0.6,
                          shared_prefix_tokens_min=20,
                          shared_prefix_tokens_max=40)


@pytest.mark.parametrize("impl", ["auto", "kernel"])
def test_real_executor_token_parity_cache_on_off_legacy(impl):
    """Identical emitted tokens with the prefix cache on vs off vs the
    dense-slot ``real-legacy`` oracle, on a duplicate- and shared-prefix
    heavy multimodal mix over a 24-page pool with one forced mid-decode
    preemption in each run."""
    from repro_torch.core.scheduler import make_policy
    from repro_torch.launch.serve import build_stack
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.workload import generate
    emitted, stats = {}, {}
    for key, kind, cache in (("on", "real", True), ("off", "real", False),
                             ("legacy", "real-legacy", True)):
        executor, classifier, engine_cfg, _, _ = build_stack(
            ARCH, kind, kv_pages=24, device="cpu")
        assert executor.attn_impl == "gather"
        if impl != "auto":
            executor.attn_impl = impl
        engine_cfg = dataclasses.replace(engine_cfg, prefix_cache=cache)
        eng = Engine(make_policy("tcm"), executor, classifier, engine_cfg)
        pending = generate(_prefix_mix())
        forced = False
        for _ in range(100000):
            pending = eng.step(pending)
            if not forced and eng.running:
                eng._preempt(next(iter(eng.running)))
                forced = True
            if len(eng.finished) + len(eng.rejected) == 10:
                break
        assert len(eng.finished) == 10
        assert sum(r.preemptions for r in eng.finished) >= 1
        eng.allocator.check_invariants()
        emitted[key] = {r.rid: eng.executor.emitted.get(r.rid)
                        for r in eng.finished}
        stats[key] = eng.allocator.prefix_stats()
    assert emitted["on"] == emitted["off"] == emitted["legacy"]
    assert all(toks for toks in emitted["on"].values())
    assert stats["on"]["hits"] > 0


def test_real_executor_cow_page_copy_is_exact():
    """The donor->private page copy (``PagedStackStore.copy_page`` over
    every layer stack): a request resuming prefill mid-page on a copied
    page emits exactly the tokens it would have emitted prefilling its
    whole prompt from scratch."""

    def _mk(rid, prompt, out=4):
        return Request(rid=rid, modality=Modality.TEXT, arrival=0.0,
                       text_tokens=prompt, prompt_tokens=prompt,
                       output_tokens=out, shared_prefix_id="cow",
                       shared_prefix_tokens=24)   # ends mid-page (24=p+8)

    def _run(ex, alloc, req, claim=None):
        if claim is not None:
            tokens, cow_src, cow_dst = claim
            ex.on_prefix_claim(req, tokens, cow_src, cow_dst)
            req.prefilled = tokens
        alloc.allocate(req.rid, req.prompt_tokens + req.output_tokens + 2)
        req.state = State.PREFILLING
        ex.run_iteration([(req, req.prompt_tokens - req.prefilled)],
                         [], [])
        req.prefilled = req.prompt_tokens
        req.state = State.RUNNING
        req.decoded = 1
        while req.decoded < req.output_tokens:
            ex.run_iteration([], [req], [])
            req.decoded += 1
        return list(ex.emitted[req.rid])

    def _fresh():
        ex = ModelExecutor(get_reduced(ARCH),
                           ExecutorConfig(max_slots=4, max_len=128),
                           device="cpu")
        alloc = BlockAllocator(num_pages=ex.allocator.num_pages,
                               page_size=PAGE)
        ex.bind_allocator(alloc)
        return ex, alloc

    ex, alloc = _fresh()
    donor = _mk("cowA", 40)
    got_a = _run(ex, alloc, donor)
    alloc.publish_prefix("cowA", donor.content_chunks())
    dup = _mk("cowB", 56)
    m = alloc.match_prefix(dup.content_chunks(), dup.prompt_tokens - 1)
    assert len(m.pages) == 1 and m.cow_valid == 8 and m.tokens == 24
    claimed, cow_dst = alloc.claim_prefix("cowB", m)
    got_b = _run(ex, alloc, dup, claim=(claimed, m.cow_src, cow_dst))
    alloc.check_invariants()
    # oracle: the same request prefilled from scratch on a fresh executor
    ex2, alloc2 = _fresh()
    assert got_b == _run(ex2, alloc2, _mk("cowB", 56))
    assert got_a == _run(ex2, alloc2, _mk("cowA", 40))


# ---------------- bare-kwargs construction -----------------------------------

def test_bare_kwargs_removed_raises_with_migration_path():
    """Bare-kwargs construction fails with the ``ExecutorConfig`` call to
    write instead, as the reference's constructor does."""
    with pytest.raises(TypeError, match=r"ExecutorConfig\(.*max_slots"):
        ModelExecutor(get_reduced(ARCH), max_slots=2, max_len=64,
                      num_pages=24)


def test_config_and_kwargs_together_rejected():
    with pytest.raises(TypeError, match="keyword arguments"):
        ModelExecutor(get_reduced(ARCH),
                      ExecutorConfig(max_slots=2, max_len=64), max_slots=4)
