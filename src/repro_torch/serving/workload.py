"""Multimodal workload generation (paper §4.1).

Poisson arrivals; three mixes:
  T0 — text-only; ML — light multimodal; MH — heavy multimodal.

Per-modality size distributions are calibrated to the paper's
characterization (Fig. 2, LLaVA-7B-like):
  * text  — highly diverse, 10..10^4 prompt tokens (lognormal), ShareGPT-like
  * image — near-constant patch counts (fixed vision tokenization, ~576
    patches +/- resizing jitter), LLaVA-Instruct-like
  * video — uniformly-sampled frames x patches/frame, 10^3..>10^5 tokens,
    LLaVA-Video-like heavy tail
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .request import Modality, Request

MIXES = {
    "T0": {"text": 1.0, "image": 0.0, "video": 0.0},
    "ML": {"text": 0.85, "image": 0.10, "video": 0.05},
    "MH": {"text": 0.50, "image": 0.30, "video": 0.20},
    # long-context video: most requests are rocks whose prompts sit near
    # the context cap (see long_context_video below) — the regime where
    # ragged paged geometry matters, since a fixed-width block table
    # charges the co-scheduled sand these rocks' context price
    "LCV": {"text": 0.30, "image": 0.10, "video": 0.60},
}


@dataclass
class WorkloadConfig:
    mix: str = "MH"
    rate: float = 2.0           # requests/second (Poisson)
    num_requests: int = 300
    seed: int = 0
    # dataset knobs
    text_tokens_log_mu: float = 5.3     # ~200 median
    text_tokens_log_sigma: float = 1.3
    image_patches: int = 576            # fixed vision tokenization
    image_patch_jitter: float = 0.15
    video_frames_min: int = 8
    video_frames_max: int = 64
    video_patches_per_frame: int = 196
    out_tokens_log_mu: float = 4.2      # ~67 median output tokens
    out_tokens_log_sigma: float = 0.8
    # P(an mm input repeats an earlier one of the same modality) —
    # exercises the engine's encoder-output cache. 0.0 keeps the RNG
    # stream identical to the historical generator (seeded workloads and
    # committed baselines are unchanged).
    duplicate_prob: float = 0.0
    # P(a text request opens with one of `shared_prefix_pool` fixed
    # system prompts) — exercises the KV prefix cache with page-aligned
    # shared text prefixes. Like duplicate_prob, 0.0 draws nothing from
    # the RNG, so seeded workloads and committed BENCH_*.json streams
    # stay byte-identical.
    shared_prefix_prob: float = 0.0
    shared_prefix_pool: int = 4
    shared_prefix_tokens_min: int = 64
    shared_prefix_tokens_max: int = 256
    # ---- trace-shaped generation (ServeGen-style) ----
    # All knobs default off and draw from a SEPARATE RNG stream, so the
    # base stream's draws — and every committed BENCH_*.json baseline —
    # stay byte-identical while the knobs are at their defaults.
    # Heavy-tailed lengths: with this probability a request's text /
    # output length is redrawn from a Pareto tail instead of the
    # lognormal body (production prompt-length CCDFs are power-law)
    heavy_tail_prob: float = 0.0
    heavy_tail_alpha: float = 1.6
    heavy_tail_text_cap: int = 32768
    heavy_tail_out_cap: int = 4096
    # Diurnal rate curve: rate(t) = rate * (1 + A*sin(2*pi*t/period)),
    # applied by rescaling the base stream's exponential gaps
    diurnal_amplitude: float = 0.0
    diurnal_period_s: float = 600.0
    # Burst windows: with this probability (checked per arrival outside
    # a burst) a burst starts, multiplying the rate by burst_factor for
    # burst_len_s seconds
    burst_prob: float = 0.0
    burst_factor: float = 4.0
    burst_len_s: float = 5.0
    # Multi-tenant client pool: > 0 assigns each request to one of N
    # tenants with zipf-skewed popularity; each tenant has a distinct
    # modality mix (interpolated text-heavy -> video-heavy around the
    # base mix) and its own shared system prompt (feeding the KV prefix
    # cache realistically). 0 = single "default" tenant.
    tenants: int = 0
    tenant_zipf_a: float = 1.2
    tenant_sys_prob: float = 0.75
    tenant_sys_tokens_min: int = 64
    tenant_sys_tokens_max: int = 256


def _shape_arrivals(cfg: WorkloadConfig, gaps: np.ndarray,
                    trng: np.random.Generator) -> np.ndarray:
    """Diurnal + burst arrival shaping: the base stream's exponential
    gaps are *rescaled* by the instantaneous rate multiplier (a thinned
    inhomogeneous Poisson process), so the base RNG stream is untouched
    — only burst starts draw from the trace RNG."""
    t = 0.0
    burst_until = -1.0
    shaped = np.empty(len(gaps))
    for i, g in enumerate(gaps):
        mult = 1.0
        if cfg.diurnal_amplitude > 0:
            mult *= max(0.05, 1.0 + cfg.diurnal_amplitude *
                        np.sin(2.0 * np.pi * t / cfg.diurnal_period_s))
        if t < burst_until:
            mult *= cfg.burst_factor
        t += g / mult
        shaped[i] = t
        if cfg.burst_prob > 0 and t >= burst_until and \
                trng.uniform() < cfg.burst_prob:
            burst_until = t + cfg.burst_len_s
    return shaped


def _tenant_pool(cfg: WorkloadConfig, mix: dict,
                 trng: np.random.Generator | None):
    """(tenant specs, zipf popularity) for the multi-tenant client pool.
    Each tenant's modality mix interpolates between a text-heavy and a
    video-heavy lean blended with the base mix — distinct but related
    clients, per ServeGen — and carries one shared system prompt."""
    if cfg.tenants <= 0:
        return [], None
    base = np.array([mix["text"], mix["image"], mix["video"]])
    specs = []
    for k in range(cfg.tenants):
        f = k / max(1, cfg.tenants - 1)
        lean = (np.array([0.90, 0.08, 0.02]) * (1 - f)
                + np.array([0.25, 0.25, 0.50]) * f)
        w = 0.5 * base + 0.5 * lean
        w = w / w.sum()
        sys_toks = int(trng.integers(cfg.tenant_sys_tokens_min,
                                     cfg.tenant_sys_tokens_max + 1))
        specs.append((f"tenant{k}", w, f"t{cfg.seed}-{k}", sys_toks))
    ranks = np.arange(1, cfg.tenants + 1, dtype=float)
    pop = ranks ** -cfg.tenant_zipf_a
    return specs, pop / pop.sum()


def generate(cfg: WorkloadConfig) -> list[Request]:
    rng = np.random.default_rng(cfg.seed)
    mix = MIXES[cfg.mix]
    modalities = rng.choice(
        ["text", "image", "video"], size=cfg.num_requests,
        p=[mix["text"], mix["image"], mix["video"]])
    gaps = rng.exponential(1.0 / cfg.rate, size=cfg.num_requests)
    arrivals = np.cumsum(gaps)

    # trace-shaped extras live on a separate RNG stream: with
    # every knob at its default this block draws nothing and the base
    # stream stays byte-identical to the historical generator
    trace_on = (cfg.heavy_tail_prob > 0 or cfg.diurnal_amplitude > 0
                or cfg.burst_prob > 0 or cfg.tenants > 0)
    trng = np.random.default_rng(cfg.seed + 0x7ACE) if trace_on else None
    if cfg.diurnal_amplitude > 0 or cfg.burst_prob > 0:
        arrivals = _shape_arrivals(cfg, gaps, trng)
    tenant_specs, tenant_pop = _tenant_pool(cfg, mix, trng)

    reqs = []
    # previously-generated mm contents per modality: (hash, units) pools
    # that duplicate_prob draws from (the same image re-asked with a new
    # question shares the hash AND the patch count — content identity)
    pools: dict[str, list[tuple[str, int]]] = {"image": [], "video": []}
    # fixed system-prompt pool (shared_prefix_prob): sizes come from a
    # separate RNG so enabling the knob leaves the main stream's draws
    # for sizes/arrivals untouched
    sys_pool: list[tuple[str, int]] = []
    if cfg.shared_prefix_prob > 0:
        prng = np.random.default_rng(cfg.seed + 0x5F5)
        sys_pool = [
            (f"s{cfg.seed}-{j}",
             int(prng.integers(cfg.shared_prefix_tokens_min,
                               cfg.shared_prefix_tokens_max + 1)))
            for j in range(cfg.shared_prefix_pool)]
    for i, (mod, t) in enumerate(zip(modalities, arrivals)):
        tenant = "default"
        shared_id, shared_toks = None, 0
        if tenant_specs:
            k = int(trng.choice(len(tenant_specs), p=tenant_pop))
            tenant, tmix, sys_id, sys_toks = tenant_specs[k]
            # tenants have distinct modality mixes: redraw from this
            # tenant's lean (the base draw above is discarded)
            mod = str(trng.choice(["text", "image", "video"], p=tmix))
            if trng.uniform() < cfg.tenant_sys_prob:
                shared_id, shared_toks = sys_id, sys_toks
        out_toks = int(np.clip(rng.lognormal(
            cfg.out_tokens_log_mu, cfg.out_tokens_log_sigma), 4, 1024))
        if cfg.heavy_tail_prob > 0 and trng.uniform() < cfg.heavy_tail_prob:
            out_toks = min(cfg.heavy_tail_out_cap,
                           int(32 * (1 + trng.pareto(cfg.heavy_tail_alpha))))
        mm_hash = None
        if mod == "text":
            text = int(np.clip(rng.lognormal(
                cfg.text_tokens_log_mu, cfg.text_tokens_log_sigma), 10, 10000))
            mm = 0
            if cfg.heavy_tail_prob > 0 and \
                    trng.uniform() < cfg.heavy_tail_prob:
                text = min(cfg.heavy_tail_text_cap,
                           int(200 * (1 + trng.pareto(cfg.heavy_tail_alpha))))
            if shared_id is None and sys_pool and \
                    rng.uniform() < cfg.shared_prefix_prob:
                shared_id, shared_toks = \
                    sys_pool[int(rng.integers(len(sys_pool)))]
        else:
            text = int(np.clip(rng.lognormal(3.6, 0.6), 8, 256))
            if cfg.duplicate_prob > 0 and pools[mod] and \
                    rng.uniform() < cfg.duplicate_prob:
                mm_hash, mm = pools[mod][int(rng.integers(len(pools[mod])))]
            else:
                if mod == "image":
                    mm = int(cfg.image_patches *
                             (1 + rng.uniform(-cfg.image_patch_jitter,
                                              cfg.image_patch_jitter)))
                else:  # video
                    frames = int(rng.integers(cfg.video_frames_min,
                                              cfg.video_frames_max + 1))
                    mm = frames * cfg.video_patches_per_frame
                mm_hash = f"{mod}-{i:05d}"
                pools[mod].append((mm_hash, mm))
        if shared_id is not None:
            text += shared_toks   # the system prompt precedes the
            #                       question in the prompt layout
        reqs.append(Request(
            rid=f"r{i:05d}", modality=Modality(mod), arrival=float(t),
            text_tokens=text, mm_units=mm, output_tokens=out_toks,
            prompt_tokens=text + mm, mm_hash=mm_hash,
            shared_prefix_id=shared_id, shared_prefix_tokens=shared_toks,
            tenant=tenant))
    return reqs


def long_context_video(cap_tokens: int, *, num_requests: int = 64,
                       rate: float = 1.0, seed: int = 0) -> WorkloadConfig:
    """Long-context video preset: an LCV-mix workload whose video rocks
    carry prompts near ``cap_tokens`` (the serving context cap).

    Frame counts are sized so a max-frame video plus its text lands just
    under the cap (~90%, leaving decode headroom) and the minimum stays
    above half of it — every video is a genuine rock, not a pebble. The
    executor context-sweep benchmark draws its long-context rung from
    this preset (benchmarks/real_executor.py), so the committed numbers
    exercise the regime the ROADMAP's video north-star cares about.
    """
    patches = 196
    frames_max = max(1, (cap_tokens * 9 // 10) // patches)
    frames_min = max(1, frames_max // 2)
    return WorkloadConfig(
        mix="LCV", rate=rate, num_requests=num_requests, seed=seed,
        video_frames_min=frames_min, video_frames_max=frames_max,
        video_patches_per_frame=patches)


def profiling_workload(seed: int = 1234, n_per_modality: int = 120) -> list[Request]:
    """Isolated-run workload for the Workload Profiler: sweeps input sizes."""
    rng = np.random.default_rng(seed)
    reqs = []
    i = 0
    for text in np.unique(np.geomspace(10, 10000, n_per_modality).astype(int)):
        reqs.append(Request(rid=f"pT{i}", modality=Modality.TEXT, arrival=0.0,
                            text_tokens=int(text), prompt_tokens=int(text)))
        i += 1
    for _ in range(n_per_modality):
        text = int(rng.integers(8, 256))
        mm = int(576 * (1 + rng.uniform(-0.15, 0.15)))
        reqs.append(Request(rid=f"pI{i}", modality=Modality.IMAGE, arrival=0.0,
                            text_tokens=text, mm_units=mm,
                            prompt_tokens=text + mm))
        i += 1
    for frames in np.unique(np.geomspace(8, 96, n_per_modality).astype(int)):
        text = int(rng.integers(8, 256))
        mm = int(frames) * 196
        reqs.append(Request(rid=f"pV{i}", modality=Modality.VIDEO, arrival=0.0,
                            text_tokens=text, mm_units=mm,
                            prompt_tokens=text + mm))
        i += 1
    return reqs
