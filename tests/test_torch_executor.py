"""The port's ``ModelExecutor`` against the JAX package's, on the same
weights (carried over by the bridge) in f32: a scripted engine-like
schedule — ragged chunked prefill, fused decode, one recompute-style
preemption, one prompt longer than the context window — must emit
identical greedy token streams, through the gather path, the kernels'
plain versions and the legacy dense-slot path, and for reduced gemma3
(sliding window, so always the dense-slot path) past the end of its slot
buffer. Plus the executor's refusals and bookkeeping, and the port's own
oracle: the engine through ``real`` and ``real-legacy`` emits the same
tokens."""
import dataclasses

import pytest
import torch
from torch_parity import bridge, jax_cfg_f32, jax_params_numpy

jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.cache import BlockAllocator as JAlloc  # noqa: E402
from repro.serving import executors as jexec  # noqa: E402
from repro.serving import request as jreq  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.cache import BlockAllocator as TAlloc  # noqa: E402
from repro_torch.serving import executors as texec  # noqa: E402
from repro_torch.serving import request as treq  # noqa: E402

ARCH, MAX_LEN, PAGE = "chatglm3-6b", 64, 16
JITTER = 0.05

# (prompt tokens, output tokens): ragged, a page boundary, over-window
SPECS = [(23, 4), (16, 3), (37, 5), (80, 3)]
CHUNK, PREEMPT_AT, VICTIM = 12, 3, 1


def _drive(ex, Alloc, R, specs, chunk, preempt_at, victim_idx):
    """Scripted engine-like schedule (as ``_drive`` in
    tests/test_batched_executor.py): chunked prefill + fused decode with
    one recompute-style preemption; returns the emitted tokens per
    request."""
    alloc = Alloc(num_pages=ex.allocator.num_pages, page_size=PAGE)
    ex.bind_allocator(alloc)
    reqs = [R.Request(rid=f"ex{i}", modality=R.Modality.TEXT, arrival=0.0,
                      text_tokens=p, prompt_tokens=p, output_tokens=o)
            for i, (p, o) in enumerate(specs)]
    for r in reqs:
        alloc.allocate(r.rid, min(r.prompt_tokens, MAX_LEN) +
                       r.output_tokens + 2)
        r.state = R.State.PREFILLING
    preempted = False
    for it in range(200):
        active = [r for r in reqs if r.state in (R.State.PREFILLING,
                                                 R.State.RUNNING)]
        if not active:
            break
        if it == preempt_at and not preempted:
            v = active[victim_idx % len(active)]
            alloc.free(v.rid)
            v.state = R.State.PREEMPTED
            ex.release_slot(v)
            v.prefilled = 0
            alloc.allocate(v.rid, min(v.prompt_tokens, MAX_LEN) +
                           v.output_tokens + 2)
            v.state = R.State.PREFILLING
            preempted = True
            continue
        prefill = [(r, min(chunk, r.prompt_tokens - r.prefilled))
                   for r in reqs if r.state is R.State.PREFILLING]
        decode = [r for r in reqs if r.state is R.State.RUNNING]
        ex.run_iteration(prefill, decode, [])
        for r, c in prefill:
            r.prefilled += c
            if r.prefilled >= r.prompt_tokens:
                r.state = R.State.RUNNING
                r.decoded = 1
        for r in decode:
            r.decoded += 1
            if r.decoded >= r.output_tokens:
                r.state = R.State.FINISHED
                alloc.free(r.rid)
                ex.release_slot(r)
    return {r.rid: list(ex.emitted.get(r.rid, [])) for r in reqs}


_JAX_TOKENS = {}


def _jax_executor(jc, **kw):
    """The JAX executor, built without drawing its own weights (the test
    replaces them with the bridged ones; eager ``jax.random`` draws take
    seconds). Its slot caches are made as declared (zeros, ones, fills:
    nothing is drawn), as the port makes them."""
    import repro.models.params as jparams
    real = jparams.init_params
    jparams.init_params = lambda decls, key, dtype=None: \
        jparams.tree_map_decls(
            lambda d: jax.numpy.zeros(d.shape, dtype or d.dtype),
            decls) if "embed" in decls else real(decls, key, dtype)
    try:
        return jexec.ModelExecutor(jc, jexec.ExecutorConfig(
            max_slots=4, max_len=MAX_LEN, page_size=PAGE, **kw))
    finally:
        jparams.init_params = real


def _jax_tokens(arch=ARCH, kind="batched", specs=SPECS, cfg_kw=()):
    """Emitted tokens of the JAX executor (``kind`` 'batched' or
    'legacy') under ``_drive``, computed once per arguments."""
    key = (arch, kind, tuple(specs), cfg_kw)
    if key not in _JAX_TOKENS:
        jc = dataclasses.replace(jax_cfg_f32(jconfigs.get_reduced(arch)),
                                 **dict(cfg_kw))
        ex = _jax_executor(jc, legacy=kind == "legacy")
        ex.params = jax.tree.map(jax.numpy.asarray,
                                 jax_params_numpy(jc, jitter=JITTER))
        _JAX_TOKENS[key] = _drive(ex, JAlloc, jreq, specs, CHUNK,
                                  PREEMPT_AT, VICTIM)
    return _JAX_TOKENS[key]


def _port(impl="auto", arch=ARCH, cfg_kw=(), **kw):
    jc = dataclasses.replace(jax_cfg_f32(jconfigs.get_reduced(arch)),
                             **dict(cfg_kw))
    tc = dataclasses.replace(tconfigs.get_reduced(arch), dtype=torch.float32,
                             **dict(cfg_kw))
    return texec.ModelExecutor(
        tc, texec.ExecutorConfig(max_slots=4, max_len=MAX_LEN,
                                 page_size=PAGE, attn_impl=impl, **kw),
        device="cpu", params=bridge(jax_params_numpy(jc, jitter=JITTER), tc))


@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_emitted_tokens_match_jax_executor(impl):
    want = _jax_tokens()
    ex = _port(impl)
    assert ex.attn_impl == impl
    got = _drive(ex, TAlloc, treq, SPECS, CHUNK, PREEMPT_AT, VICTIM)
    assert got == want
    assert [len(got[f"ex{i}"]) for i in range(len(SPECS))] == \
        [o for _, o in SPECS]
    assert len(ex.recompile_keys) <= ex.recompile_bound()


@pytest.mark.parametrize("jax_kind", ["batched", "legacy"])
def test_legacy_executor_matches_jax_executor(jax_kind):
    """The port's dense-slot path against the JAX batched executor and its
    legacy oracle (which the JAX package holds equal to each other)."""
    want = _jax_tokens(kind=jax_kind)
    ex = _port(legacy=True)
    assert ex.legacy and not ex.supports_prefix_cache
    got = _drive(ex, TAlloc, treq, SPECS, CHUNK, PREEMPT_AT, VICTIM)
    assert got == want
    assert ex.free_slots and not ex.slot_of and not ex.recompile_keys


# sliding window 16 (reduced gemma3's 64 would never bite at MAX_LEN 64);
# the 80-token prompt fills the slot to 60 and its 24 decodes run its cache
# idx to 84, past Smax + window, where the queries see no key in the window
GEMMA = (("sliding_window", 16),)
GEMMA_SPECS = [(23, 4), (80, 24), (37, 5)]


def test_gemma3_executor_matches_jax_legacy_executor_past_max_len():
    want = _jax_tokens("gemma3-27b", "legacy", GEMMA_SPECS, GEMMA)
    ex = _port(arch="gemma3-27b", cfg_kw=GEMMA)
    assert ex.legacy and not ex.paged_ok      # sliding window: dense slots
    got = _drive(ex, TAlloc, treq, GEMMA_SPECS, CHUNK, PREEMPT_AT, VICTIM)
    assert got == want
    assert [len(got[f"ex{i}"]) for i in range(len(GEMMA_SPECS))] == \
        [o for _, o in GEMMA_SPECS]


def test_auto_impl_is_gather_on_cpu_and_entry_points_need_cuda():
    assert _port().attn_impl == "gather"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            texec.ModelExecutor(tconfigs.get_reduced(ARCH))


def test_unported_paths_raise_naming_the_roadmap():
    """Nothing is refused any more: every arch's block types construct.
    The attention and MoE decoders take the batched paged path; jamba
    (Mamba state), xLSTM, whisper (cross attention) and gemma3 (sliding
    window) take the dense-slot path by themselves; ``legacy=True`` puts
    any arch there. (The name dates from when the unported paths raised.)"""
    dense_only = {"jamba_1_5_large_398b", "xlstm_125m", "whisper_base",
                  "gemma3_27b"}
    for arch in tconfigs.ARCH_IDS:
        tc = tconfigs.get_reduced(arch)
        paged = arch not in dense_only
        for legacy in (False, True):
            ex = texec.ModelExecutor(tc, texec.ExecutorConfig(
                legacy=legacy, max_slots=1, max_len=32), device="cpu")
            assert ex.paged_ok == paged
            assert ex.legacy == (legacy or not paged)


def _legacy_req(rid, prompt=12, out=2):
    return treq.Request(rid=rid, modality=treq.Modality.TEXT, arrival=0.0,
                        text_tokens=prompt, prompt_tokens=prompt,
                        output_tokens=out)


def test_slot_capacity_error_and_release_resets_the_slot():
    ex = _port(legacy=True)
    reqs = [_legacy_req(f"s{i}") for i in range(5)]
    for r in reqs[:4]:
        ex.acquire_slot(r)
    with pytest.raises(texec.SlotCapacityError,
                       match="all 4 slots busy — raise max_slots or lower "
                             "EngineConfig.max_num_seqs"):
        ex.acquire_slot(reqs[4])
    r = reqs[0]
    ex.release_slot(r)
    ex.allocator.allocate(r.rid, 16)
    ex.run_iteration([(r, 12)], [], [])
    slot = ex.slot_of[r.rid]
    cache = ex.caches[slot]
    assert int(cache["idx"]) == 12
    k = cache["stages"][0]["b0"]["k"]
    assert k.abs().sum() > 0 and k.dtype == torch.bfloat16
    r.state = treq.State.FINISHED
    ex.release_slot(r)
    assert slot in ex.free_slots and r.rid not in ex.slot_of
    assert ex.caches[slot] is cache and int(cache["idx"]) == 0
    assert k.abs().sum() == 0          # zeroed in place, not reallocated


def test_isolated_run_clamps_to_the_pool_and_extrapolates():
    ex = _port()
    req = treq.Request(rid="iso", modality=treq.Modality.TEXT, arrival=0.0,
                       text_tokens=40, prompt_tokens=40, output_tokens=2)
    rec = ex.isolated_run(req)
    assert rec.prefill_time > 0 and rec.prompt_tokens == 40
    assert ex.allocator.available_pages == ex.allocator.num_pages
    # a pool with room for one page measures 16 tokens, prices 40
    ex.allocator.allocate("hog", (ex.allocator.num_pages - 1) * PAGE)
    rec2 = ex.isolated_run(req)
    assert rec2.prefill_time > 0
    assert ex.allocator.owned_pages("__profile__iso") == 0


def test_prefix_claim_copies_the_boundary_page_in_place():
    ex = _port()
    store = ex.stores[0]["b0"]
    store.k_pages[3] = 1.5
    ex.on_prefix_claim(treq.Request(rid="c", modality=treq.Modality.TEXT,
                                    arrival=0.0, text_tokens=8,
                                    prompt_tokens=8, output_tokens=1),
                       tokens=5, cow_src=3, cow_dst=7)
    assert ex._ctx["c"] == 5
    assert torch.equal(store.k_pages[7], store.k_pages[3])


@pytest.mark.parametrize("impl", ["auto", "kernel"])
def test_port_engine_real_and_real_legacy_emit_the_same_tokens(impl):
    """The port's own token-parity oracle, as the JAX package's
    tests/test_batched_executor.py holds its own: the same multimodal
    workload through the engine with the batched (``real``) and the
    sequential dense-slot (``real-legacy``) executor, one recompute-style
    preemption injected in each, emits the same tokens. Both executors
    take one attention route, so both paths share its numerics: the
    default ("auto", the gather path and ``mha`` on the CPU, as the
    reference's executors take it) and the kernels (their plain versions
    here, the route the card runs)."""
    from repro_torch.core.scheduler import make_policy
    from repro_torch.launch.serve import build_stack
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.workload import WorkloadConfig, generate
    wl = WorkloadConfig(mix="ML", rate=50.0, num_requests=10, seed=7,
                        out_tokens_log_mu=1.8, out_tokens_log_sigma=0.3,
                        text_tokens_log_mu=3.2, text_tokens_log_sigma=0.5,
                        video_frames_min=1, video_frames_max=2,
                        image_patches=32, video_patches_per_frame=16)
    emitted, preempts = {}, {}
    for kind in ("real", "real-legacy"):
        executor, classifier, engine_cfg, _, _ = build_stack(
            "chatglm3-6b", kind, kv_pages=24, device="cpu")
        assert executor.legacy == (kind == "real-legacy")
        assert executor.attn_impl == "gather"
        if impl != "auto":
            executor.attn_impl = impl
        eng = Engine(make_policy("tcm"), executor, classifier, engine_cfg)
        pending = generate(wl)
        forced = False
        for _ in range(100000):
            pending = eng.step(pending)
            if not forced and eng.running:
                eng._preempt(next(iter(eng.running)))  # mid-decode evict
                forced = True
            if len(eng.finished) + len(eng.rejected) == 10:
                break
        done = eng.finished
        assert len(done) == 10
        emitted[kind] = {r.rid: eng.executor.emitted.get(r.rid)
                         for r in done}
        preempts[kind] = sum(r.preemptions for r in done)
        eng.allocator.check_invariants()
    assert emitted["real"] == emitted["real-legacy"]
    assert all(toks for toks in emitted["real"].values())
    assert preempts["real"] >= 1 and preempts["real-legacy"] >= 1
