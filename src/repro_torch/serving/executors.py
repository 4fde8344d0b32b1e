"""Execution backends for the serving engine.

SimExecutor — iteration-cost model calibrated to the paper's own
characterization (Figs. 2 and 6): per-token prefill cost from model FLOPs /
device throughput, quadratic attention term, per-iteration decode cost,
modality preprocess/encode stage costs. Used for workload-scale scheduler
experiments (the scheduler sees the identical engine API either way).

ModelExecutor — runs the real torch model, on the GPU by default. Each
engine iteration runs as one packed ragged prefill step plus one fused
decode step over the whole running set, with per-layer KV in flat paged
stores indexed by the engine allocator's block tables (DESIGN.md §Batched
execution path). On CUDA, attention goes through the hand-written paged
kernels.
"""
from __future__ import annotations

import time
import zlib
from collections import deque
from dataclasses import dataclass, replace

import numpy as np

from repro_torch.core.profiler import ProfileRecord

from .request import TERMINAL_STATES, Modality, Request


@dataclass
class CostModel:
    """Analytic A100-class iteration-time model for one MLLM.

    prefill: t = c_base + c_tok * T + c_attn * T^2   (T = chunk tokens;
    the quadratic term uses chunk x context for chunked prefill)
    decode:  t = d_base + d_tok * B (+ attention over context)
    encode:  per-modality preprocess/encode from unit counts.
    """
    name: str = "llava-7b"
    n_params: float = 7e9
    peak_flops: float = 312e12 * 0.60   # A100 bf16 with realistic MFU
    c_base: float = 0.004
    d_base: float = 0.008
    kv_bytes_per_token: float = 2 * 32 * 1024 * 2  # 2(KV) * L*d_kv * bf16
    hbm_bw: float = 1.5e12 * 0.8
    # vision stage (calibrated to paper Fig. 6: image TTFT < 1 s, video 1-10 s)
    img_preproc_s: float = 0.030
    img_encode_per_patch: float = 5e-5
    vid_preproc_per_frame: float = 0.004
    vid_encode_per_patch: float = 2.5e-5
    # encode/LLM stage overlap (RServe-style pipelining): fraction of the
    # shorter stage hidden behind the longer when both run in the same
    # iteration (< 1.0: launch gaps, shared SMs/HBM contention)
    overlap_efficiency: float = 0.88

    def prefill_time(self, chunk_tokens: int, ctx_before: int) -> float:
        flops = 2.0 * self.n_params * chunk_tokens
        # attention reads the context KV once per chunk
        attn = (ctx_before + chunk_tokens / 2) * chunk_tokens * 4e-9 / 50
        return flops / self.peak_flops + attn

    def decode_time(self, batch: int, ctx_tokens_total: int) -> float:
        # weights + KV reads are bandwidth-bound at decode
        weight_read = 2.0 * self.n_params / self.hbm_bw
        kv_read = ctx_tokens_total * self.kv_bytes_per_token / self.hbm_bw
        return weight_read + kv_read + 2.0 * self.n_params * batch / self.peak_flops

    def preprocess_time(self, req: Request) -> float:
        if req.modality == Modality.IMAGE:
            return self.img_preproc_s
        if req.modality == Modality.VIDEO:
            frames = req.mm_units / 196
            return self.vid_preproc_per_frame * frames
        return 0.0

    def encode_chunk_time(self, req: Request, units: int) -> float:
        """Encoder time for ``units`` patches of this request's modality.
        Linear in units, so chunked encode conserves total work exactly."""
        if req.modality == Modality.IMAGE:
            return self.img_encode_per_patch * units
        if req.modality == Modality.VIDEO:
            return self.vid_encode_per_patch * units
        return 0.0

    def encode_time(self, req: Request) -> float:
        return self.encode_chunk_time(req, req.mm_units)


# Paper-table model presets (Table 1) + assigned archs. Coefficients scale
# with LLM-backend parameter count; vision stages with encoder size.
MODEL_PRESETS = {
    "llava-500m": dict(n_params=5e8, d_base=0.004),
    "llava-7b": dict(n_params=7e9),
    "gemma-4b": dict(n_params=4e9),
    "gemma-12b": dict(n_params=12e9),
    "qwen-3b": dict(n_params=3e9),
    "qwen-7b": dict(n_params=7e9, vid_encode_per_patch=1.2e-4),
    "pixtral-12b": dict(n_params=12e9, img_encode_per_patch=5e-5),
}


def make_cost_model(name: str) -> CostModel:
    return CostModel(name=name, **MODEL_PRESETS[name])


def cost_model_for_arch(cfg) -> CostModel:
    """Cost model derived from an assigned architecture's dimensions."""
    from repro_torch.models.params import param_count
    from repro_torch.models.transformer import model_decls
    n = param_count(model_decls(cfg))
    kv_bytes = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.hd * 2
    return CostModel(name=cfg.name, n_params=float(n),
                     kv_bytes_per_token=float(max(kv_bytes, 1)))


class SimExecutor:
    """Calibrated discrete-event executor.

    ``overlap=True`` pipelines the vision-encode stage with LLM
    prefill/decode inside an iteration (max- rather than sum-composition
    of the stage times, up to ``CostModel.overlap_efficiency``); with
    ``overlap=False`` the stages serialize, which is the ablation baseline
    for benchmarks/encode_overlap.py. Stage-second counters accumulate
    across iterations so tests can assert work conservation.
    """

    # the sim's "KV" is pure accounting, so shared prefix pages cost
    # nothing to honor: residual chunks simply never reach the cost model
    supports_prefix_cache = True

    def __init__(self, cost_model: CostModel, decode_block: int = 1,
                 overlap: bool = True):
        self.cm = cost_model
        self.overlap = overlap
        self.llm_seconds = 0.0       # prefill + decode stage time
        self.encode_seconds = 0.0    # vision-encode stage time
        self.overlap_saved_seconds = 0.0
        self.busy_seconds = 0.0      # sum of returned iteration durations
        self.prefill_tokens = 0      # prompt tokens actually prefilled

    def preprocess_delay(self, req: Request) -> float:
        return self.cm.preprocess_time(req)

    def fresh(self) -> "SimExecutor":
        """A cold executor of the same configuration — what a restarted
        replica binds: same cost model, zeroed counters, no
        per-request state (all of that died with the old process)."""
        return SimExecutor(self.cm, overlap=self.overlap)

    # -- profiler interface -------------------------------------------------
    def isolated_run(self, req: Request) -> ProfileRecord:
        pre = self.cm.preprocess_time(req)
        enc = self.cm.encode_time(req)
        prefill = self.cm.prefill_time(req.prompt_tokens, 0)
        return ProfileRecord(
            modality=req.modality.value, text_tokens=req.text_tokens,
            mm_units=req.mm_units, prompt_tokens=req.prompt_tokens,
            preprocess_time=pre, encode_time=enc, prefill_time=prefill)

    def isolated_e2e(self, req: Request) -> float:
        """Isolated end-to-end latency; called once per request at ingest
        (SLO assignment), so the decode sum over
        ``decode_time(1, prompt + i) for i < output_tokens`` is evaluated in
        closed form: the cost model is affine in context, so the sum is an
        arithmetic series — O(1) instead of an O(output_tokens) loop.

        A cached KV prefix (``req.cached_prefix_tokens``) shrinks the
        prefill term to the residual tokens (attention still reads the
        cached context), so the SLO ranks by the work actually left."""
        rec = self.isolated_run(req)
        ttft = rec.ttft
        cached = min(req.cached_prefix_tokens, max(req.prompt_tokens - 1, 0))
        if cached > 0:
            ttft = (rec.preprocess_time + rec.encode_time +
                    self.cm.prefill_time(req.prompt_tokens - cached, cached))
        n = req.output_tokens
        base = self.cm.decode_time(1, 0)          # weights + batch FLOPs term
        kv_coef = self.cm.kv_bytes_per_token / self.cm.hbm_bw
        ctx_sum = n * req.prompt_tokens + n * (n - 1) // 2
        return ttft + n * base + kv_coef * ctx_sum

    # -- engine interface ----------------------------------------------------
    def run_iteration(self, prefill_work, decode_reqs, encode_work) -> float:
        """Returns the iteration duration in (simulated) seconds.

        prefill_work: list[(Request, chunk_tokens)]; decode_reqs: requests
        each generating one token; encode_work: list[(Request,
        chunk_units)] vision-encode chunks running this iteration.
        Preprocess runs async on CPU (vLLM-style), so only encode hits the
        accelerator; with overlap enabled the encode stream hides behind
        (or hides) the LLM stream up to the overlap efficiency.
        """
        t_enc = 0.0
        for req, units in encode_work:
            t_enc += self.cm.encode_chunk_time(req, units)
        t_llm = 0.0
        if prefill_work:
            t_llm += self.cm.c_base
            for r, c in prefill_work:
                t_llm += self.cm.prefill_time(c, r.prefilled)
                self.prefill_tokens += c
        if decode_reqs:
            ctx = sum(r.prompt_tokens + r.decoded for r in decode_reqs)
            t_llm += self.cm.decode_time(len(decode_reqs), ctx)
        saved = 0.0
        if self.overlap and t_enc > 0.0 and t_llm > 0.0:
            saved = self.cm.overlap_efficiency * min(t_llm, t_enc)
        dur = max(t_llm + t_enc - saved, 1e-3)
        self.llm_seconds += t_llm
        self.encode_seconds += t_enc
        self.overlap_saved_seconds += saved
        self.busy_seconds += dur
        return dur


@dataclass(frozen=True)
class ExecutorConfig:
    """Validated construction surface for ``ModelExecutor``.

    One place for what used to be ``__init__`` kwarg sprawl; Engine,
    Router, benchmarks and tests construct through it (bare-kwargs
    construction was removed after its one-release deprecation window
    and now raises ``TypeError``).

    ``resolved()`` is the single derivation point for the ``num_pages``
    default from slot geometry — the constructor and
    ``launch.serve.build_stack`` previously each re-derived it, so the
    admission path and the paged stores agree by construction now.
    """
    max_slots: int = 8
    max_len: int = 512
    seed: int = 0
    legacy: bool = False
    attn_impl: str = "auto"        # auto | kernel | gather
    page_size: int = 16
    num_pages: int | None = None   # None -> resolved() fills the default
    ragged: bool = True

    def __post_init__(self):
        if self.max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {self.max_slots}")
        if self.max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {self.max_len}")
        if self.page_size < 1:
            raise ValueError(
                f"page_size must be >= 1, got {self.page_size}")
        if self.attn_impl not in ("auto", "kernel", "gather"):
            raise ValueError(
                f"attn_impl must be 'auto', 'kernel' or 'gather', got "
                f"{self.attn_impl!r}")
        if self.num_pages is not None and self.num_pages < 1:
            raise ValueError(
                f"num_pages must be >= 1 (or None), got {self.num_pages}")

    @property
    def default_num_pages(self) -> int:
        """KV capacity implied by the slot geometry: pages covering
        ``max_slots`` full context windows."""
        return max(1, self.max_slots * self.max_len // self.page_size)

    def resolved(self) -> "ExecutorConfig":
        """Fill every derived field; idempotent. An explicit
        ``num_pages`` decouples KV capacity from the slot geometry
        (prefix-cache-heavy configs hold far more resident KV than
        ``max_slots x max_len`` implies)."""
        if self.num_pages is not None:
            return self
        return replace(self, num_pages=self.default_num_pages)




class ModelExecutor:
    """Real-torch backend over a model config, on the GPU by default.

    Per-layer KV lives in ``PagedStackStore`` page pools shared by every
    request; the engine allocator's page lists become real block tables.
    Each iteration runs as at most two forward calls — a packed ragged
    prefill over this iteration's chunks and one fused decode step over
    the entire running set — and the stores are updated in place, so a
    step's cost is independent of KV store *capacity*: only live tokens
    are touched. Batch, chunk, AND block-table width are bucketed to
    powers of two (the table rounds the batch's max live page count up,
    capped at ``max_pages``), so attention/scatter traffic scales with
    live context instead of the context cap, and the set of distinct call
    shapes (``recompile_keys``, the specialisation keys of any future
    captured graph) stays O(log) per axis, bounded by
    ``recompile_bound()``.

    Greedy tokens (argmax, fed back as the next decode input) are emitted
    into ``emitted``. Every timed region ends in a device synchronise, so
    the profile and the engine clock measure device work, not launches.

    Not ported yet (ROADMAP.md): ``legacy=True`` (the dense-slot oracle),
    archs outside the paged protocol, MoE blocks, and the page-chain
    migration payloads.
    """

    # finished-request token lists retained for post-run inspection
    # (parity tests, benchmarks); bounded so long-running serving does not
    # leak one list per completed request
    EMITTED_RETAIN = 4096

    def __init__(self, cfg, config: ExecutorConfig | None = None, *,
                 device="cuda", params=None):
        import torch

        from repro_torch.cache import BlockAllocator
        from repro_torch.device import resolve_device
        from repro_torch.models import transformer as T
        from repro_torch.models.config import ATTN
        from repro_torch.models.params import init_params, tree_map
        if config is None:
            config = ExecutorConfig()
        config = config.resolved()
        if config.legacy:
            raise NotImplementedError(
                "legacy=True (the dense-slot oracle) is not ported yet "
                "(ROADMAP.md: dense slot cache and attention_block)")
        if not T.paged_supported(cfg) or any(
                bt != ATTN for period, _ in cfg.stages() for bt in period):
            raise NotImplementedError(
                f"{cfg.name}: only attention-only archs on the paged path "
                "are ported (ROADMAP.md: MoE; SSM/xLSTM/whisper; sliding "
                "window)")
        self.torch = torch
        self.T = T
        self.device = resolve_device(device)
        self.config = config
        self.cfg = cfg
        self.max_len = config.max_len
        self.max_slots = config.max_slots
        # ragged=False pins the block table at the max_pages cap — the
        # fixed-geometry ablation/baseline for the context-sweep benchmark
        self.ragged = config.ragged
        if config.attn_impl == "auto":
            # hand-written kernels on the card; the gather + mha path on
            # CPU (the kernels' plain versions also run there when asked)
            self.attn_impl = ("kernel" if self.device.type == "cuda"
                              else "gather")
        else:
            self.attn_impl = config.attn_impl
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(config.seed)
            # drawn in f32 and cast leaf by leaf: only cfg.dtype copies
            # stay resident (bf16 on the card)
            params = init_params(T.model_decls(cfg), gen, dtype=cfg.dtype,
                                 device=self.device)
        else:
            params = T.cast_params(
                tree_map(lambda a: a.to(self.device), params,
                         is_leaf=torch.is_tensor), cfg.dtype)
        self.params = params
        self.layers = T.layer_params(params, cfg)
        # page accounting: replaced by the engine's allocator via
        # bind_allocator; standalone use gets a private one sized by the
        # resolved config (launch plumbs EngineConfig.kv_pages through
        # ExecutorConfig.num_pages so the paged stores match the
        # engine's capacity from the start).
        self.allocator = BlockAllocator(num_pages=config.num_pages,
                                        page_size=config.page_size)
        self._stores = None           # lazy: [{bname: PagedStackStore}]
        self._ctx: dict[str, int] = {}        # KV tokens written per rid
        self._isolated_ttft: dict[str, float] = {}  # measured profile
        #   prefill per rid: repricing an SLO at admission (prefix claim
        #   shifted) must not re-run a profile prefill — the pool may be
        #   full at that point
        self.emitted: dict[str, list[int]] = {}
        self._finished_rids = deque()
        self._prompt_cache: dict[str, np.ndarray] = {}
        self.recompile_keys: set[tuple] = set()

    # -- plumbing -----------------------------------------------------------
    def _sync(self) -> None:
        from repro_torch.device import synchronize
        synchronize(self.device)

    def bind_allocator(self, allocator) -> None:
        """Adopt the engine's BlockAllocator: its page ids index the paged
        stores directly (id P — one past the allocator's last — is the
        reserved trash page for ragged-batch padding writes)."""
        if self._stores is not None and (
                allocator.num_pages != self.allocator.num_pages
                or allocator.page_size != self.allocator.page_size):
            self._stores = None   # re-created lazily at the new geometry
        self.allocator = allocator

    def _make_stores(self):
        from repro_torch.cache.paged import PagedStackStore, store_dtype
        cfg = self.cfg
        ppl = self.allocator.num_pages + 1    # +1: per-layer trash page
        page = self.allocator.page_size
        itemsize = self.torch.empty(
            (), dtype=store_dtype(self.device)).element_size()
        bytes_total = sum(
            2 * reps * ppl * page * cfg.num_kv_heads * cfg.hd * itemsize
            * len(period) for period, reps in cfg.stages())
        if bytes_total > 8 << 30:
            raise ValueError(
                f"paged stores would need {bytes_total / 2**30:.1f} GiB "
                f"({ppl} pages/layer x {page}); size EngineConfig.kv_pages "
                "to the executor (serve.build_stack does this for real "
                "mode)")
        return [{f"b{bi}": PagedStackStore.build(
                    reps, ppl, page, cfg.num_kv_heads, cfg.hd,
                    device=self.device)
                 for bi, _bt in enumerate(period)}
                for period, reps in cfg.stages()]

    @property
    def supports_prefix_cache(self) -> bool:
        """The batched paged path shares KV between requests."""
        return True

    @property
    def prefix_token_limit(self) -> int:
        """Cap on claimable prefix tokens: a claimed row must still start
        inside the context window so its residual chunk can run."""
        return max(0, self.max_len - 8)

    def on_prefix_claim(self, req: Request, tokens: int,
                        cow_src: int | None = None,
                        cow_dst: int | None = None) -> None:
        """Engine hook at admission: the claimed prefix's KV already sits
        in shared pages (rows 0.. of this request's block table), so
        writes and rope start at ``tokens``; the partially-shared
        boundary page is copied donor->private in place."""
        self._ctx[req.rid] = int(tokens)
        self.emitted.pop(req.rid, None)   # recompute re-claims cleanly
        if cow_src is None or cow_dst is None:
            return
        if self._stores is None:
            self._stores = self._make_stores()
        with self.torch.no_grad():
            for stage in self._stores:
                for s in stage.values():
                    s.copy_page(cow_src, cow_dst)

    def evict_request(self, rid: str) -> None:
        """Drop every per-rid memo (prompt stream, profile, emitted) for a
        request that will never run here again."""
        self._prompt_cache.pop(rid, None)
        self._isolated_ttft.pop(rid, None)
        self.emitted.pop(rid, None)
        self._ctx.pop(rid, None)

    @property
    def max_pages(self) -> int:
        """Block-table width *cap*: pages covering the per-request context
        window. Per-call tables are length-bucketed below this (see
        ``_bucket_pages``); ``ragged=False`` pins every call here, the
        fixed-geometry ablation baseline."""
        return -(-self.max_len // self.allocator.page_size)

    def _bucket_pages(self, need: int) -> int:
        """Block-table width for a call whose widest row holds ``need``
        live pages: round up to a power of two (so call shapes stay
        O(log) along the context axis), clamped to the ``max_pages`` cap.
        Attention and scatter traffic then scale with the batch's live
        context instead of charging every call the context-cap price."""
        if not self.ragged:
            return self.max_pages
        return min(self._bucket(max(need, 1)), self.max_pages)

    @staticmethod
    def _n_buckets(n: int) -> int:
        """Distinct power-of-two buckets covering 1..n — the O(log n)
        factor each bucketed shape axis contributes."""
        return (max(n, 1) - 1).bit_length() + 1

    def recompile_bound(self) -> int:
        """Ceiling on ``len(recompile_keys)``: each call-shape axis is
        bucketed, so distinct shapes are bounded by the product of O(log)
        per-axis bucket counts — O(log B · log C · log P) for prefill plus
        O(log B · log P) for decode."""
        b_seen = max((k[1] for k in self.recompile_keys), default=1)
        nb = self._n_buckets(b_seen)
        nc = self._n_buckets(self.max_len)
        npg = self._n_buckets(self.max_pages)
        return nb * nc * npg + nb * npg

    # -- deterministic token streams / emission -----------------------------
    def _prompt_tokens(self, req: Request) -> np.ndarray:
        toks = self._prompt_cache.get(req.rid)
        if toks is None:
            chunks = req.content_chunks()
            if len(chunks) == 1 and chunks[0][0] == f"txt!{req.rid}":
                # fully-private prompt: the rid-seeded stream (stable
                # digest, so runs reproduce across processes)
                seed = zlib.crc32(req.rid.encode()) & 0x7FFFFFFF
                toks = np.random.default_rng(seed).integers(
                    1, self.cfg.vocab_size, size=req.prompt_tokens,
                    dtype=np.int64)
            else:
                # per-segment streams seeded by *content id*: requests
                # carrying the same system prompt or mm payload see
                # identical tokens there, so a shared prefix page's KV
                # really is interchangeable between them
                toks = np.concatenate([
                    np.random.default_rng(
                        zlib.crc32(cid.encode()) & 0x7FFFFFFF).integers(
                        1, self.cfg.vocab_size, size=n, dtype=np.int64)
                    for cid, n in chunks]) if chunks else \
                    np.zeros(0, np.int64)
            self._prompt_cache[req.rid] = toks
        return toks

    def release_slot(self, req: Request):
        """Drop a request's executor-side state (engine calls this on
        preemption and on finish)."""
        self._ctx.pop(req.rid, None)
        if req.state in TERMINAL_STATES:
            # terminal (finished/rejected/failed/cancelled) requests never
            # run again: their profile memo and token arrays must not
            # outlive them (rejected ones carry the *largest* prompts)
            self._prompt_cache.pop(req.rid, None)
            self._isolated_ttft.pop(req.rid, None)
            if req.rid in self.emitted:
                self._finished_rids.append(req.rid)
                while len(self._finished_rids) > self.EMITTED_RETAIN:
                    self.emitted.pop(self._finished_rids.popleft(), None)
        else:
            # recompute-style preemption: the re-prefill re-emits the same
            # deterministic tokens from scratch
            self.emitted.pop(req.rid, None)

    # -- profiler interface -------------------------------------------------
    def isolated_run(self, req: Request) -> ProfileRecord:
        n = min(req.prompt_tokens, self.max_len - 8)
        t0 = time.perf_counter()
        rid = f"__profile__{req.rid}"
        # admission-time profiling borrows pages from the live pool; a
        # near-full pool must clamp the measurement, not crash serving.
        # Prefill is ~linear in tokens at these sizes (the residual
        # pricing in isolated_e2e already relies on that), so measure
        # the longest prefix that fits and extrapolate; a completely
        # full pool falls back to the last measured per-token rate.
        meas = min(n, self.allocator.available_pages
                   * self.allocator.page_size)
        if meas > 0:
            self.allocator.allocate(rid, meas)
            try:
                toks = self._prompt_tokens(req)[:meas]
                self._paged_prefill_call([(rid, toks, 0, 0, meas)])
                self._sync()
            finally:
                self.allocator.free(rid)
        prefill = time.perf_counter() - t0
        if meas < n:
            prefill = (prefill * n / meas if meas > 0
                       else getattr(self, "_profile_rate", 1e-4) * n)
        if n > 0 and meas > 0:
            self._profile_rate = prefill / n
        self.release_slot(req)
        self._prompt_cache.pop(req.rid, None)
        return ProfileRecord(
            modality=req.modality.value, text_tokens=req.text_tokens,
            mm_units=req.mm_units, prompt_tokens=req.prompt_tokens,
            preprocess_time=0.0, encode_time=0.0, prefill_time=prefill)

    def isolated_e2e(self, req: Request) -> float:
        ttft = self._isolated_ttft.get(req.rid)
        if ttft is None:
            ttft = self.isolated_run(req).ttft
            self._isolated_ttft[req.rid] = ttft
        cached = min(req.cached_prefix_tokens, max(req.prompt_tokens - 1, 0))
        if cached > 0 and req.prompt_tokens > 0:
            # measured prefill is ~linear in tokens at these sizes: price
            # only the residual the request will actually run
            ttft *= (req.prompt_tokens - cached) / req.prompt_tokens
        return ttft * (1 + 0.1 * req.output_tokens)

    def encode_chunk(self, req: Request, units: int) -> None:
        """Vision-encoder stage hook. The models ship no real encoder, so
        this stands in with a chunk-sized device matmul — the engine clock
        still pays a *measured* per-chunk cost, and subclasses override
        this to run an actual encoder."""
        n = max(1, min(int(units), 256))
        x = self.torch.ones((n, 32), dtype=self.torch.float32,
                            device=self.device)
        x @ x.T
        self._sync()

    # -- shared iteration-plan normalization --------------------------------
    # Row filters resolve degenerate corners (mid-plan preemption,
    # duplicate chunk entries, context-window clamping) exactly as the JAX
    # executor does, so both emit the same tokens for the same plan.
    def _prefill_rows(self, prefill_work):
        """-> [(req, rope_start, n, emits_first_token)]."""
        rows = []
        est: dict[str, int] = {}
        for req, chunk in prefill_work:
            if self.allocator.owned_pages(req.rid) == 0:
                continue   # preempted later in the same planning pass
            start = est.get(req.rid, req.prefilled)
            est[req.rid] = start + chunk
            n = min(chunk, self.max_len - start - 4)
            if n <= 0:
                continue   # context window exhausted: no KV work possible
            # emit the first token either at the true prompt end or — for
            # prompts exceeding the context window — at the last in-window
            # chunk, so over-window requests still enter the decode path
            # (and pay real decode compute) instead of being dropped
            done = (start + chunk >= req.prompt_tokens
                    or start + n >= self.max_len - 4)
            rows.append((req, start, n, done))
        return rows

    def _decode_rows(self, decode_reqs):
        rows = []
        for req in decode_reqs:
            if (self.allocator.owned_pages(req.rid) == 0
                    or req.rid not in self._ctx
                    or not self.emitted.get(req.rid)):
                continue   # preempted mid-plan / never finished prefill
            rows.append(req)
        return rows

    # -- engine interface ----------------------------------------------------
    def run_iteration(self, prefill_work, decode_reqs, encode_work) -> float:
        t0 = time.perf_counter()
        for req, units in encode_work:
            self.encode_chunk(req, units)
        self._batched_iteration(self._prefill_rows(prefill_work),
                                self._decode_rows(decode_reqs))
        self._sync()
        return time.perf_counter() - t0

    # -- batched paged path ---------------------------------------------------
    @staticmethod
    def _bucket(n: int) -> int:
        return 1 << max(0, (n - 1).bit_length())

    def _step(self, tokens, positions, bt, lengths, new_lens):
        """One forward over the paged stores (prefill chunk or decode:
        decode is a 1-token prefill with new_lens 1 -> last_pos 0);
        returns each row's argmax token, on the device."""
        torch = self.torch
        dev = self.device
        args = [torch.from_numpy(a).to(dev)
                for a in (tokens, positions, bt, lengths, new_lens)]
        tokens, positions, bt, lengths, new_lens = args
        cache = {"stages": self._stores, "block_table": bt,
                 "lengths": lengths, "new_lens": new_lens}
        with torch.no_grad():
            logits, _, _ = self.T.forward(
                self.params, self.cfg, tokens, positions=positions,
                cache=cache, last_pos=torch.clamp(new_lens - 1, min=0),
                attn_impl=self.attn_impl, layers=self.layers)
            return torch.argmax(logits[:, 0], dim=-1)

    def _block_table_rows(self, rids, maxp: int) -> np.ndarray:
        trash = self.allocator.num_pages
        bt = np.full((len(rids), maxp), trash, np.int32)
        for i, rid in enumerate(rids):
            pages = self.allocator.pages_of(rid)[:maxp]
            bt[i, :len(pages)] = pages
        return bt

    def _paged_prefill_call(self, rows):
        """rows: [(rid, tokens ndarray, rope_start, write_start, n)].
        Runs one packed prefill step; returns last-token ids (B,) on the
        device (not synchronised)."""
        if self._stores is None:
            self._stores = self._make_stores()
        B = self._bucket(len(rows))
        C = self._bucket(max(n for *_x, n in rows))
        page = self.allocator.page_size
        # live pages after this call's writes: ceil((write_start+n)/page)
        maxp = self._bucket_pages(
            max(-(-(ws + n) // page) for _r, _t, _rs, ws, n in rows))
        self.recompile_keys.add(("prefill", B, C, maxp))
        toks = np.zeros((B, C), np.int32)
        pos = np.zeros((B, C), np.int32)
        lengths = np.zeros((B,), np.int32)
        new_lens = np.zeros((B,), np.int32)
        for i, (_rid, t, rope_start, write_start, n) in enumerate(rows):
            toks[i, :n] = t
            pos[i] = rope_start + np.arange(C)
            lengths[i] = write_start
            new_lens[i] = n
        bt = np.full((B, maxp), self.allocator.num_pages, np.int32)
        bt[:len(rows)] = self._block_table_rows([r[0] for r in rows], maxp)
        return self._step(toks, pos, bt, lengths, new_lens)

    def _batched_iteration(self, prefill_rows, decode_rows):
        # waves: a request may legitimately appear twice in one plan
        # (preempted then re-admitted); its chunks must apply in order and
        # never share one scatter (duplicate indices are unordered)
        waves: list[list] = []
        seen_at: dict[str, int] = {}
        for row in prefill_rows:
            w = seen_at.get(row[0].rid, -1) + 1
            seen_at[row[0].rid] = w
            if w == len(waves):
                waves.append([])
            waves[w].append(row)
        for wave in waves:
            # write_start read per wave: a later wave of the same request
            # starts where the previous wave's writes ended
            rows = [(req.rid, self._prompt_tokens(req)[rope:rope + n],
                     rope, self._ctx.get(req.rid, 0), n)
                    for req, rope, n, _d in wave]
            out = self._paged_prefill_call(rows).cpu().numpy()
            for i, (req, _rope, n, done) in enumerate(wave):
                self._ctx[req.rid] = rows[i][3] + n
                if done:
                    self.emitted.setdefault(req.rid, []).append(int(out[i]))
        if not decode_rows:
            return
        if self._stores is None:
            self._stores = self._make_stores()
        B = self._bucket(len(decode_rows))
        page = self.allocator.page_size
        # each row writes one token at position ctx, so the live context
        # after the step is ctx+1 tokens
        maxp = self._bucket_pages(
            max(-(-(self._ctx[r.rid] + 1) // page) for r in decode_rows))
        self.recompile_keys.add(("decode", B, maxp))
        toks = np.zeros((B, 1), np.int32)
        pos = np.zeros((B, 1), np.int32)
        lengths = np.zeros((B,), np.int32)
        new_lens = np.zeros((B,), np.int32)
        for i, req in enumerate(decode_rows):
            toks[i, 0] = self.emitted[req.rid][-1]
            pos[i, 0] = min(req.prompt_tokens + req.decoded - 1,
                            self.max_len - 2)
            lengths[i] = self._ctx[req.rid]
            new_lens[i] = 1
        bt = np.full((B, maxp), self.allocator.num_pages, np.int32)
        bt[:len(decode_rows)] = self._block_table_rows(
            [r.rid for r in decode_rows], maxp)
        out = self._step(toks, pos, bt, lengths, new_lens).cpu().numpy()
        for i, req in enumerate(decode_rows):
            self._ctx[req.rid] += 1
            self.emitted[req.rid].append(int(out[i]))
