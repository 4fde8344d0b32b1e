"""The port's ``ModelExecutor`` against the JAX package's, on the same
weights (carried over by the bridge) in f32: a scripted engine-like
schedule — ragged chunked prefill, fused decode, one recompute-style
preemption, one prompt longer than the context window — must emit
identical greedy token streams, through both the gather path and the
kernels' plain versions. Plus the executor's refusals and bookkeeping."""
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


def _jax_executor(jc):
    """The JAX executor, built without drawing its own weights (the test
    replaces them with the bridged ones; eager ``jax.random`` draws take
    seconds)."""
    import repro.models.params as jparams
    real = jparams.init_params
    jparams.init_params = lambda decls, key, dtype=None: \
        jparams.tree_map_decls(
            lambda d: jax.numpy.zeros(d.shape, dtype or d.dtype), decls)
    try:
        return jexec.ModelExecutor(jc, jexec.ExecutorConfig(
            max_slots=4, max_len=MAX_LEN, page_size=PAGE))
    finally:
        jparams.init_params = real


def _jax_tokens():
    if not _JAX_TOKENS:
        jc = jax_cfg_f32(jconfigs.get_reduced(ARCH))
        ex = _jax_executor(jc)
        ex.params = jax.tree.map(jax.numpy.asarray,
                                 jax_params_numpy(jc, jitter=JITTER))
        _JAX_TOKENS.update(_drive(ex, JAlloc, jreq, SPECS, CHUNK,
                                  PREEMPT_AT, VICTIM))
    return _JAX_TOKENS


def _port(impl="auto", **kw):
    jc = jax_cfg_f32(jconfigs.get_reduced(ARCH))
    tc = dataclasses.replace(tconfigs.get_reduced(ARCH), dtype=torch.float32)
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


def test_auto_impl_is_gather_on_cpu_and_entry_points_need_cuda():
    assert _port().attn_impl == "gather"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            texec.ModelExecutor(tconfigs.get_reduced(ARCH))


def test_unported_paths_raise_naming_the_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port(legacy=True)
    for arch in ("phi3.5-moe-42b-a6.6b", "xlstm-125m", "gemma3-27b"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            texec.ModelExecutor(tconfigs.get_reduced(arch), device="cpu")


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
    ex._stores = ex._make_stores()
    store = ex._stores[0]["b0"]
    store.k_pages[3] = 1.5
    ex.on_prefix_claim(treq.Request(rid="c", modality=treq.Modality.TEXT,
                                    arrival=0.0, text_tokens=8,
                                    prompt_tokens=8, output_tokens=1),
                       tokens=5, cow_src=3, cow_dst=7)
    assert ex._ctx["c"] == 5
    assert torch.equal(store.k_pages[7], store.k_pages[3])
