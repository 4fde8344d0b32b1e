"""Execution backends for the serving engine.

SimExecutor — iteration-cost model calibrated to the paper's own
characterization (Figs. 2 and 6): per-token prefill cost from model FLOPs /
device throughput, quadratic attention term, per-iteration decode cost,
modality preprocess/encode stage costs. Used for workload-scale scheduler
experiments (the scheduler sees the identical engine API either way).

ModelExecutor — runs the real torch model, on the GPU by default. The
default batched mode executes each engine iteration as packed ragged
calls over the paged stores (a prefill wave each, and the decode of the
whole running set as one call of one-token chunks), with
per-layer KV in flat paged stores indexed by the engine allocator's block
tables (DESIGN.md §Batched execution path): the attention and MoE
decoders. ``legacy=True`` — and every arch outside the paged protocol
(gemma3's sliding window, jamba's Mamba layers, xLSTM, the whisper
encoder-decoder) — runs one ``forward`` per request over a dense
per-request slot cache: the token-parity oracle of the batched path. On CUDA, attention goes through
the hand-written kernels (paged decode and prefill; dense prefill).
"""
from __future__ import annotations

import time
import zlib
from collections import deque
from dataclasses import dataclass, replace

import numpy as np

from repro_torch import obs
from repro_torch.core.profiler import ProfileRecord

from .request import TERMINAL_STATES, Modality, Request


class SlotCapacityError(RuntimeError):
    """Legacy dense-slot executor ran out of request slots (the seed raised
    a bare IndexError from ``free_slots.pop()``). Raise ``max_slots`` or
    lower ``EngineConfig.max_num_seqs``."""


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
    for benchmarks/encode_overlap.py.
    """

    # the sim's "KV" is pure accounting, so shared prefix pages cost
    # nothing to honor: residual chunks simply never reach the cost model
    supports_prefix_cache = True

    def __init__(self, cost_model: CostModel, overlap: bool = True):
        self.cm = cost_model
        self.overlap = overlap

    def preprocess_delay(self, req: Request) -> float:
        return self.cm.preprocess_time(req)

    def fresh(self) -> "SimExecutor":
        """A cold executor of the same configuration — what a restarted
        replica binds: same cost model, no per-request state (all of
        that died with the old process)."""
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
        if decode_reqs:
            ctx = sum(r.prompt_tokens + r.decoded for r in decode_reqs)
            t_llm += self.cm.decode_time(len(decode_reqs), ctx)
        saved = 0.0
        if self.overlap and t_enc > 0.0 and t_llm > 0.0:
            saved = self.cm.overlap_efficiency * min(t_llm, t_enc)
        return max(t_llm + t_enc - saved, 1e-3)


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




# Calls of at most this many padded tokens (B·C, a decode counting C=1)
# are captured as CUDA graphs and replayed; larger ones run eagerly. On an
# H100, full-width qwen2-vl-2b's eager forward takes 18-37 ms to enqueue at
# every shape; a replay's device time reaches that between 4096 tokens
# (32 ms) and 8192 (71 ms), past which a graph saves under 5% (PERF.md §5).
GRAPH_MAX_TOKENS = 4096


class CudaGraphCapture:
    """Captures a function of static tensors as a CUDA graph: run once on
    a side stream first (the warm-up torch asks for), then captured on
    that stream into one memory pool shared by all of its owner's graphs.
    The owner replays them one at a time on one stream and reads each
    output before the next replay, so no graph needs another's scratch."""

    def __init__(self, torch):
        self.torch = torch
        self.stream = torch.cuda.Stream()
        self.pool = torch.cuda.graph_pool_handle()

    def __call__(self, fn):
        """-> (graph, fn's output); ``graph.replay()`` redoes fn's device
        work into that output."""
        torch = self.torch
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            fn()
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=self.pool)
            try:
                out = fn()
            finally:
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(self.stream)
        return graph, out


@dataclass
class _Graph:
    """One call shape's captured forward: its static inputs (tokens,
    positions, block table, lengths, new_lens), its output ids (B,), the
    kernel launches one replay makes, by kernel, and the seconds of the
    last timed isolated prefill of the shape (None until one is kept)."""
    graph: object
    inputs: tuple
    out: object
    launches: dict
    price: float | None = None


class ModelExecutor:
    """Real-torch backend over a model config, on the GPU by default.

    Per-layer KV lives in ``PagedStackStore`` page pools shared by every
    request (``stores``, built on first use); the engine allocator's page
    lists become real block tables. Every forward of an iteration is one
    packed call (``_paged_call``) over rows of (rid, tokens, rope start,
    write start, n): a prefill wave's chunks, and the decode of the entire
    running set as one-token chunks. The stores are updated in place, so a
    step's cost is independent of KV store *capacity*: only live tokens
    are touched. Batch, chunk, AND block-table width are bucketed to
    powers of two (``_call_shape``; the table rounds the batch's max live
    page count up, capped at ``max_pages``), so attention/scatter traffic
    scales with live context instead of the context cap, and the set of
    distinct call shapes ``(B, C, maxp)`` (``recompile_keys``) stays
    O(log) per axis, bounded by ``recompile_bound()``.

    On CUDA the batched path replays a CUDA graph per call shape,
    captured at the shape's first call, for every
    shape of at most ``GRAPH_MAX_TOKENS`` padded tokens; larger calls run
    eagerly. Each call copies its whole bucket-shaped inputs into the
    graph's static buffers, so nothing of an earlier call survives in
    them. A capture is warmed up on inputs that are padding everywhere
    (its writes land on the trash page) and serves no call, so the
    kernels' ``launches`` count what each replay launches. The graphs
    hold the paged stores' pointers and are dropped with them.

    ``legacy=True`` keeps one ``forward`` per request per iteration over a
    dense slot cache per request (``max_slots`` of them, at ``max_len``,
    updated in place and zeroed in place when a slot is released); it is
    the token-parity oracle of the batched path and the path of archs the
    paged protocol does not take (sliding-window attention, recurrent
    state, cross attention). Only the last position's logits are
    computed, the only ones it reads. A released slot is zeroed whole, as
    the JAX executor zeroes it: the recurrent fills (an sLSTM's ``n`` of
    ones, an mLSTM's ``m`` of -1e30) become zeros there too.

    Greedy tokens (argmax, fed back as the next decode input) are emitted
    into ``emitted``. Every timed region ends in a device synchronise, so
    the profile and the engine clock measure device work, not launches.

    With ``repro_torch.obs`` on, the batched path is traced in spans:
    ``exec.iteration`` (a whole ``run_iteration``) and
    ``exec.admission_profile`` (a whole ``isolated_run``) hold
    ``exec.encode`` (each encode chunk), ``exec.prefill`` (each prefill
    wave) and ``exec.decode``, each of those ``exec.pack`` (rows and block
    tables), ``exec.upload`` (the host-to-device copies), ``exec.forward``
    (the model's enqueue and the argmax) and ``exec.readback``, and
    ``exec.sync`` each closing synchronise, and ``exec.capture`` each
    graph capture. The counter ``exec.syncs`` counts every host-device
    synchronisation at its call site, on any device: each synchronise,
    readback and blocking upload; ``exec.graph_captures``,
    ``exec.graph_replays`` and ``exec.graph_eager`` (CUDA calls above the
    token bound) count how the batched path's forward calls ran;
    ``exec.price_reused`` and ``exec.price_timed`` how ``isolated_e2e``
    priced each new request: from the kept seconds of a timed isolated
    prefill of its call shape (stored on the shape's graph, and dropped
    with it), or by an ``isolated_run``.

    Replicas of one model share its weights: pass an executor's ``params``
    and ``layers`` to the next one, which then keeps only its own stores,
    allocator and per-request state.
    """

    # finished-request token lists retained for post-run inspection
    # (parity tests, benchmarks); bounded so long-running serving does not
    # leak one list per completed request
    EMITTED_RETAIN = 4096

    def __init__(self, cfg, config: ExecutorConfig | None = None, *,
                 device="cuda", params=None, layers=None, **kwargs):
        import torch

        from repro_torch.cache import BlockAllocator
        from repro_torch.device import resolve_device
        from repro_torch.models import transformer as T
        from repro_torch.models.params import init_params, tree_map
        if kwargs:
            # bare-kwargs construction is gone: fail loudly with the
            # migration path, as the reference's constructor does
            raise TypeError(
                "ModelExecutor no longer accepts bare keyword arguments "
                f"({sorted(kwargs)}); construct an ExecutorConfig — "
                "ModelExecutor(cfg, ExecutorConfig("
                + ", ".join(f"{k}=..." for k in sorted(kwargs)) + "))")
        if config is None:
            config = ExecutorConfig()
        config = config.resolved()
        self.torch = torch
        self.T = T
        self.device = resolve_device(device)
        self.config = config
        self.cfg = cfg
        self.max_len = config.max_len
        self.max_slots = config.max_slots
        self.paged_ok = T.paged_supported(cfg)
        self.legacy = config.legacy or not self.paged_ok
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
        # the forward reads the fused weights only: the stacked q/k/v
        # projections are dropped as each block is fused (so a replica
        # takes the fused ``layers`` of the executor whose params it shares)
        self.layers = layers if layers is not None else \
            T.layer_params(params, cfg, release=True)
        # dense per-request slot caches: only the legacy path keeps them
        # (the batched path retires the slot store for attention KV)
        self.caches = ([T.init_cache(cfg, 1, self.max_len,
                                     device=self.device)
                        for _ in range(self.max_slots)]
                       if self.legacy else None)
        self.slot_of: dict[str, int] = {}
        self.free_slots = list(range(self.max_slots))
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
        self._profile_rate = 1e-4     # profile seconds per token, last seen
        self.emitted: dict[str, list[int]] = {}
        self._finished_rids = deque()
        self._prompt_cache: dict[str, np.ndarray] = {}
        self.recompile_keys: set[tuple] = set()
        # captured forwards by call shape (B, C, maxp); None: no capture
        self._capture = (CudaGraphCapture(torch)
                         if self.device.type == "cuda" and not self.legacy
                         else None)
        self._graphs: dict[tuple, _Graph] = {}

    # -- plumbing -----------------------------------------------------------
    def _sync(self) -> None:
        from repro_torch.device import synchronize
        obs.count("exec.syncs")
        synchronize(self.device)

    def _wait(self) -> None:
        """The synchronise that closes a timed region."""
        with obs.span("exec.sync"):
            self._sync()

    @staticmethod
    def _readback(ids) -> np.ndarray:
        with obs.span("exec.readback"):
            out = ids.cpu().numpy()
        obs.count("exec.syncs")
        return out

    def bind_allocator(self, allocator) -> None:
        """Adopt the engine's BlockAllocator: its page ids index the paged
        stores directly (id P — one past the allocator's last — is the
        reserved trash page for ragged-batch padding writes)."""
        if self._stores is not None and (
                allocator.num_pages != self.allocator.num_pages
                or allocator.page_size != self.allocator.page_size):
            self._stores = None   # re-created lazily at the new geometry
            self._graphs = {}     # they hold the old stores' pointers
        self.allocator = allocator

    @property
    def capacity_pages(self) -> int:
        return self.allocator.num_pages

    @property
    def stores(self):
        """The paged KV stores, per stage ``{bname: PagedStackStore}``,
        built at the allocator's geometry on first use."""
        if self._stores is None:
            self._stores = self._make_stores()
        return self._stores

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
        """Only the batched paged path shares KV between requests; the
        legacy dense-slot oracle keeps per-request caches and opts out
        (the engine then never claims or publishes)."""
        return not self.legacy

    def _profile_tokens(self, prompt_tokens: int) -> int:
        """Tokens an admission profile of a ``prompt_tokens`` prompt runs:
        the prompt, cut to leave its row room inside the context window."""
        return min(prompt_tokens, self.max_len - 8)

    @property
    def prefix_token_limit(self) -> int:
        """Cap on claimable prefix tokens: a claimed row must still start
        inside the context window so its residual chunk can run."""
        return max(0, self._profile_tokens(self.max_len))

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
        with self.torch.no_grad():
            for stage in self.stores:
                for s in stage.values():
                    s.copy_page(cow_src, cow_dst)

    def evict_request(self, rid: str) -> None:
        """Drop every per-rid memo (prompt stream, profile, emitted) for a
        request that will never run here again."""
        self._prompt_cache.pop(rid, None)
        self._isolated_ttft.pop(rid, None)
        self.emitted.pop(rid, None)
        self._ctx.pop(rid, None)

    # -- page-chain migration payloads ---------------------------------------
    def export_page_payload(self, pages: list[int]) -> list[bytes]:
        """Serialize the KV bytes of allocator ``pages`` — one ``bytes``
        blob per page, concatenating every stage/block store's
        ``export_page`` K then V rows in declaration order. The blob is
        the wire payload the migration protocol checksums, chunks, and (on
        the target) hands to ``import_page_payload`` at the target's own
        page ids; both replicas share the model config, so the layout is
        positional. Values are bf16-rounded on write (cache.paged), so
        payload round-trips are bit-exact and migrated prefixes decode the
        same tokens the source would have."""
        out = []
        for p in pages:
            parts = []
            for stage in self.stores:
                for s in stage.values():
                    k, v = s.export_page(p)
                    parts.append(k.tobytes())
                    parts.append(v.tobytes())
            out.append(b"".join(parts))
        return out

    def import_page_payload(self, pages: list[int],
                            payloads: list[bytes]) -> None:
        """Write transferred page blobs into this replica's stores, in
        place, at the target-side page ids ``pages``
        (``export_page_payload``'s inverse). Raises ``ValueError`` when
        the counts differ or a blob's length is not the stores' page
        size."""
        from repro_torch.cache.paged import host_dtype
        if len(pages) != len(payloads):
            raise ValueError(f"{len(pages)} pages but {len(payloads)} "
                             "payloads")
        stores = [s for stage in self.stores for s in stage.values()]
        shapes = [(s.layers,) + tuple(s.k_pages.shape[1:]) for s in stores]
        dt = host_dtype(stores[0].k_pages.dtype)
        want = 2 * sum(int(np.prod(sh)) for sh in shapes) * dt.itemsize
        for p, blob in zip(pages, payloads):
            if len(blob) != want:
                raise ValueError(
                    f"page payload of {len(blob)} bytes, the stores take "
                    f"{want}")
            # a writable copy: torch.from_numpy shares the array's memory
            data = np.frombuffer(bytearray(blob), dt)
            off = 0
            for s, shape in zip(stores, shapes):
                n = int(np.prod(shape))
                k = data[off:off + n].reshape(shape)
                v = data[off + n:off + 2 * n].reshape(shape)
                s.import_page(p, k, v)
                off += 2 * n

    @property
    def max_pages(self) -> int:
        """Block-table width *cap*: pages covering the per-request context
        window. Per-call tables are length-bucketed below this (see
        ``_bucket_pages``)."""
        return -(-self.max_len // self.allocator.page_size)

    def _bucket_pages(self, need: int) -> int:
        """Block-table width for a call whose widest row holds ``need``
        live pages: round up to a power of two (so call shapes stay
        O(log) along the context axis), clamped to the ``max_pages`` cap.
        Attention and scatter traffic then scale with the batch's live
        context instead of charging every call the context-cap price."""
        return min(self._bucket(max(need, 1)), self.max_pages)

    @staticmethod
    def _n_buckets(n: int) -> int:
        """Distinct power-of-two buckets covering 1..n — the O(log n)
        factor each bucketed shape axis contributes."""
        return (max(n, 1) - 1).bit_length() + 1

    def recompile_bound(self) -> int:
        """Ceiling on ``len(recompile_keys)``: each axis of a call shape
        ``(B, C, maxp)`` is bucketed, so distinct shapes are bounded by the
        product of O(log) per-axis bucket counts, O(log B · log C · log P);
        C's buckets start at 1, a decode's."""
        b_seen = max((k[0] for k in self.recompile_keys), default=1)
        return (self._n_buckets(b_seen) * self._n_buckets(self.max_len)
                * self._n_buckets(self.max_pages))

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

    def _tokens_for(self, req: Request, start: int, n: int):
        toks = self._prompt_tokens(req)[start:start + n]
        obs.count("exec.syncs")
        return self.torch.from_numpy(toks).to(self.device)[None]

    # -- legacy slot management ---------------------------------------------
    def acquire_slot(self, req: Request):
        if req.rid not in self.slot_of:
            if not self.free_slots:
                raise SlotCapacityError(
                    f"no free slot for {req.rid}: all {self.max_slots} "
                    "slots busy — raise max_slots or lower "
                    "EngineConfig.max_num_seqs")
            self.slot_of[req.rid] = self.free_slots.pop()
        return self.slot_of[req.rid]

    def release_slot(self, req: Request):
        """Drop a request's executor-side state (engine calls this on
        preemption and on finish); a legacy slot's cache, ``idx``
        included, is zeroed in place."""
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
        slot = self.slot_of.pop(req.rid, None)
        if slot is not None:
            from repro_torch.models.params import tree_leaves
            for leaf in tree_leaves(self.caches[slot], self.torch.is_tensor):
                leaf.zero_()
            self.free_slots.append(slot)

    # -- profiler interface -------------------------------------------------
    def isolated_run(self, req: Request) -> ProfileRecord:
        with obs.span("exec.admission_profile"):
            return self._isolated_run(req)

    def _isolated_run(self, req: Request) -> ProfileRecord:
        n = self._profile_tokens(req.prompt_tokens)
        meas, kept = n, None
        if not self.legacy:
            # admission-time profiling borrows pages from the live pool; a
            # near-full pool must clamp the measurement, not crash serving.
            # Prefill is ~linear in tokens at these sizes (the residual
            # pricing in isolated_e2e already relies on that), so measure
            # the longest prefix that fits and extrapolate; a completely
            # full pool falls back to the last measured per-token rate.
            meas = min(n, self.allocator.available_pages
                       * self.allocator.page_size)
            if meas > 0:
                # the profile times what serving pays, a replay: a new
                # call shape is captured before the clock starts. Its time
                # is kept as the shape's price unless this call captured
                # the graph, whose first replay also uploads it
                shape = self._call_shape([meas], [meas])
                kept = self._graphs.get(shape)
                self._graph_for(shape)
        t0 = time.perf_counter()
        if self.legacy:
            slot = self.acquire_slot(req)
            self.caches[slot] = self._legacy_forward(
                self._tokens_for(req, 0, n), None, self.caches[slot], 0)[1]
            self._wait()
        else:
            rid = f"__profile__{req.rid}"
            if meas > 0:
                self.allocator.allocate(rid, meas)
                try:
                    with obs.span("exec.prefill"):
                        with obs.span("exec.pack"):
                            toks = self._prompt_tokens(req)[:meas]
                        self._paged_call([(rid, toks, 0, 0, meas)])
                    self._wait()
                finally:
                    self.allocator.free(rid)
        prefill = time.perf_counter() - t0
        if kept is not None:
            kept.price = prefill
        if meas < n:
            prefill = (prefill * n / meas if meas > 0
                       else self._profile_rate * n)
        if n > 0 and meas > 0:
            self._profile_rate = prefill / n
        self.release_slot(req)
        self._prompt_cache.pop(req.rid, None)
        return ProfileRecord(
            modality=req.modality.value, text_tokens=req.text_tokens,
            mm_units=req.mm_units, prompt_tokens=req.prompt_tokens,
            preprocess_time=0.0, encode_time=0.0, prefill_time=prefill)

    def _kept_price(self, req: Request) -> float | None:
        """The kept seconds of a timed isolated prefill of the call shape
        ``req``'s own isolated prefill takes; None where that shape has no
        graph (no capture here, or above the token bound) or no price."""
        n = self._profile_tokens(req.prompt_tokens)
        if n <= 0:
            return None
        g = self._graphs.get(self._call_shape([n], [n]))
        return None if g is None else g.price

    def isolated_e2e(self, req: Request) -> float:
        ttft = self._isolated_ttft.get(req.rid)
        if ttft is None:
            # a replayed shape runs the same recorded kernels at every
            # call: its kept price stands for a timed run, which would
            # borrow pages and wait for the card
            ttft = self._kept_price(req)
            if ttft is None:
                obs.count("exec.price_timed")
                ttft = self.isolated_run(req).ttft
            else:
                obs.count("exec.price_reused")
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
        with obs.span("exec.encode"):
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
        with obs.span("exec.iteration"):
            for req, units in encode_work:
                self.encode_chunk(req, units)
            step = self._legacy_iteration if self.legacy else \
                self._batched_iteration
            step(self._prefill_rows(prefill_work),
                 self._decode_rows(decode_reqs))
            self._wait()
        return time.perf_counter() - t0

    # -- legacy sequential path (token-parity oracle) ------------------------
    def _legacy_forward(self, tokens, positions, cache, q_start):
        """One request's forward over its slot cache (written in place):
        (last position's logits (1, 1, V), cache with ``idx`` advanced).

        It follows the executor's attention route, as the batched path
        does: "gather" attends through ``mha`` (the reference's dense-cache
        numerics, and the gather path's, so the two paths emit the same
        tokens), "kernel" through the dense kernel. It serves every
        dense-slot forward: the ``real-legacy`` oracle, the archs outside
        the paged protocol, and the legacy ``isolated_run``."""
        with self.torch.no_grad():
            logits, cache, _ = self.T.forward(
                self.params, self.cfg, tokens, positions=positions,
                cache=cache, q_start=q_start, last_only=True,
                causal_impl="mha" if self.attn_impl == "gather"
                else "kernel", layers=self.layers)
        return logits, cache

    def _legacy_iteration(self, prefill_rows, decode_rows):
        torch = self.torch
        for req, rope_start, n, done in prefill_rows:
            # slot acquired only after the n>0 check: the seed's
            # `n <= 0: continue` leaked the just-acquired slot
            slot = self.acquire_slot(req)
            logits, self.caches[slot] = self._legacy_forward(
                self._tokens_for(req, rope_start, n), None,
                self.caches[slot], rope_start)
            self._ctx[req.rid] = self._ctx.get(req.rid, 0) + n
            if done:
                obs.count("exec.syncs")
                tok = int(torch.argmax(logits[0, -1]))
                self.emitted.setdefault(req.rid, []).append(tok)
        for req in decode_rows:
            slot = self.acquire_slot(req)
            pos = min(req.prompt_tokens + req.decoded - 1, self.max_len - 2)
            tok = torch.full((1, 1), self.emitted[req.rid][-1],
                             dtype=torch.int64, device=self.device)
            logits, self.caches[slot] = self._legacy_forward(
                tok, torch.full((1, 1), pos, dtype=torch.int64,
                                device=self.device), self.caches[slot], pos)
            self._ctx[req.rid] += 1
            obs.count("exec.syncs")
            self.emitted[req.rid].append(int(torch.argmax(logits[0, 0])))

    # -- batched paged path ---------------------------------------------------
    @staticmethod
    def _bucket(n: int) -> int:
        return 1 << max(0, (n - 1).bit_length())

    def _step(self, tokens, positions, bt, lengths, new_lens):
        """One forward over the paged stores (prefill chunk or decode:
        decode is a 1-token prefill with new_lens 1 -> last_pos 0);
        returns each row's argmax token, on the device: on CUDA, up to
        the token bound, the output of the call shape's graph, which the
        shape's next call overwrites."""
        from repro_torch.kernels import ops
        torch = self.torch
        host = (tokens, positions, bt, lengths, new_lens)
        g = self._graph_for((*tokens.shape, bt.shape[1]))
        # five blocking copies from pageable memory: each waits for the
        # stream
        with obs.span("exec.upload"):
            if g is None:
                args = [torch.from_numpy(a).to(self.device) for a in host]
            else:
                for buf, a in zip(g.inputs, host):
                    buf.copy_(torch.from_numpy(a))
        obs.count("exec.syncs", len(host))
        with obs.span("exec.forward"):
            if g is None:
                if self._capture is not None:
                    obs.count("exec.graph_eager")
                return self._forward(*args)
            g.graph.replay()
        ops.add_launch_counts(g.launches)
        obs.count("exec.graph_replays")
        return g.out

    def _forward(self, tokens, positions, bt, lengths, new_lens):
        """The model over the paged stores and the argmax, on device
        tensors: each row's next token (B,)."""
        torch = self.torch
        cache = {"stages": self.stores, "block_table": bt,
                 "lengths": lengths, "new_lens": new_lens}
        with torch.no_grad():
            logits, _, _ = self.T.forward(
                self.params, self.cfg, tokens, positions=positions,
                cache=cache, last_pos=torch.clamp(new_lens - 1, min=0),
                attn_impl=self.attn_impl, layers=self.layers)
            return torch.argmax(logits[:, 0], dim=-1)

    def _graph_for(self, shape):
        """The captured forward of call shape ``(B, C, maxp)``, captured
        at its first call; None where the call runs eagerly (no capture
        here, or more than ``GRAPH_MAX_TOKENS`` padded tokens)."""
        if self._capture is None:
            return None
        g = self._graphs.get(shape)
        if g is None and shape[0] * shape[1] <= GRAPH_MAX_TOKENS:
            g = self._graphs[shape] = self._capture_graph(shape)
        return g

    def _capture_graph(self, shape) -> _Graph:
        from repro_torch.kernels import ops
        torch = self.torch
        B, C, maxp = shape
        with obs.span("exec.capture"):
            self.stores      # built here, not on the capture's stream
            i32 = dict(dtype=torch.int32, device=self.device)
            # padding everywhere: the warm-up writes the trash page only
            inputs = (torch.zeros((B, C), **i32), torch.zeros((B, C), **i32),
                      torch.full((B, maxp), self.allocator.num_pages, **i32),
                      torch.zeros((B,), **i32), torch.zeros((B,), **i32))
            before = ops.launch_counts()
            launched = {}

            def forward():
                at = ops.launch_counts()
                out = self._forward(*inputs)
                launched.update({k: n - at[k] for k, n in
                                 ops.launch_counts().items()})
                return out
            graph, out = self._capture(forward)
            # the warm-up and the capture served no call
            ops.add_launch_counts({k: before[k] - n for k, n in
                                   ops.launch_counts().items()})
        obs.count("exec.graph_captures")
        return _Graph(graph, inputs, out, launched)

    def _block_table_rows(self, rids, maxp: int) -> np.ndarray:
        trash = self.allocator.num_pages
        bt = np.full((len(rids), maxp), trash, np.int32)
        for i, rid in enumerate(rids):
            pages = self.allocator.pages_of(rid)[:maxp]
            bt[i, :len(pages)] = pages
        return bt

    def _call_shape(self, ns, ends):
        """(B, C, maxp) of a packed call of rows of ``ns`` tokens whose
        writes end at ``ends``: the batch, the widest chunk and the live
        pages after the writes, ceil(end / page), each bucketed. The key
        of the call's graph and of ``recompile_keys``."""
        page = self.allocator.page_size
        return (self._bucket(len(ns)), self._bucket(max(ns)),
                self._bucket_pages(max(-(-e // page) for e in ends)))

    def _paged_call(self, rows):
        """rows: [(rid, tokens, rope_start, write_start, n)]. Runs one
        packed call over the paged stores (a decode row is a one-token
        chunk); returns each row's last-token id (B,) on the device (not
        synchronised)."""
        with obs.span("exec.pack"):
            rids, tokens, rope, write, ns = zip(*rows)
            B, C, maxp = shape = self._call_shape(
                ns, [w + n for w, n in zip(write, ns)])
            self.recompile_keys.add(shape)
            R = len(rows)
            toks = np.zeros((B, C), np.int32)
            pos = np.zeros((B, C), np.int32)
            lengths = np.zeros((B,), np.int32)
            new_lens = np.zeros((B,), np.int32)
            pos[:R] = np.add.outer(rope, np.arange(C))
            lengths[:R] = write
            new_lens[:R] = ns
            if C == 1:      # one token a row (a decode): one column
                toks[:R, 0] = [t[0] for t in tokens]
            else:           # row-major, as the rows' tokens concatenate
                toks[:R][np.arange(C) < new_lens[:R, None]] = \
                    np.concatenate(tokens)
            bt = np.full((B, maxp), self.allocator.num_pages, np.int32)
            bt[:R] = self._block_table_rows(rids, maxp)
        return self._step(toks, pos, bt, lengths, new_lens)

    def _run_rows(self, rows, emits):
        """One packed call over ``rows`` and its readback: each row's KV
        then ends at write_start + n, and a row that ``emits`` appends its
        token."""
        out = self._readback(self._paged_call(rows))
        for (rid, _t, _rope, write_start, n), emit, tok in zip(rows, emits,
                                                                out):
            self._ctx[rid] = write_start + n
            if emit:
                self.emitted.setdefault(rid, []).append(int(tok))

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
            with obs.span("exec.prefill"):
                # write_start read per wave: a later wave of the same
                # request starts where the previous wave's writes ended
                with obs.span("exec.pack"):
                    rows = [(req.rid, self._prompt_tokens(req)[rope:rope + n],
                             rope, self._ctx.get(req.rid, 0), n)
                            for req, rope, n, _d in wave]
                self._run_rows(rows, [done for *_x, done in wave])
        if decode_rows:
            with obs.span("exec.decode"):
                # each row feeds back its last token, one position on
                with obs.span("exec.pack"):
                    rows = [(req.rid, [self.emitted[req.rid][-1]],
                             min(req.prompt_tokens + req.decoded - 1,
                                 self.max_len - 2), self._ctx[req.rid], 1)
                            for req in decode_rows]
                self._run_rows(rows, [True] * len(rows))
