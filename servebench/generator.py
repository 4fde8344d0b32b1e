"""Traffic: the requests of one run, made from a mix file and ``--seed``.

``generate`` is a frozen copy of ``serving/workload.generate``
(``src/repro_torch/serving/workload.py`` at commit 1a285e9: the paper's
T0/ML/MH mixes, Poisson arrivals, bursts, diurnal rates, tenants, shared
system prompts, duplicates), returning plain records instead of the
program's requests. Its clip bounds and the multimodal requests' text draw
are parameters here, with the program's values as defaults.

``window`` makes one run's requests. Every seed gets the same set of sizes
and gaps, drawn once from the mix file's ``base_seed``, in another order:
the seed shuffles which sizes arrive when and what the prompts hold, but
not how much work the window carries, so runs of different seeds measure
the same load.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np

MIXES = {
    "T0": {"text": 1.0, "image": 0.0, "video": 0.0},
    "ML": {"text": 0.85, "image": 0.10, "video": 0.05},
    "MH": {"text": 0.50, "image": 0.30, "video": 0.20},
    "LCV": {"text": 0.30, "image": 0.10, "video": 0.60},
}


@dataclass
class Mix:
    """A traffic mix's parameters (``WorkloadConfig``'s, and the clip
    bounds the program hard-codes)."""
    mix: str = "MH"
    rate: float = 2.0
    num_requests: int = 300
    seed: int = 0
    text_tokens_log_mu: float = 5.3
    text_tokens_log_sigma: float = 1.3
    text_tokens_min: int = 10
    text_tokens_max: int = 10000
    mm_text_log_mu: float = 3.6
    mm_text_log_sigma: float = 0.6
    mm_text_min: int = 8
    mm_text_max: int = 256
    image_patches: int = 576
    image_patch_jitter: float = 0.15
    video_frames_min: int = 8
    video_frames_max: int = 64
    video_patches_per_frame: int = 196
    out_tokens_log_mu: float = 4.2
    out_tokens_log_sigma: float = 0.8
    out_tokens_min: int = 4
    out_tokens_max: int = 1024
    duplicate_prob: float = 0.0
    shared_prefix_prob: float = 0.0
    shared_prefix_pool: int = 4
    shared_prefix_tokens_min: int = 64
    shared_prefix_tokens_max: int = 256
    heavy_tail_prob: float = 0.0
    heavy_tail_alpha: float = 1.6
    heavy_tail_text_cap: int = 32768
    heavy_tail_out_cap: int = 4096
    diurnal_amplitude: float = 0.0
    diurnal_period_s: float = 600.0
    burst_prob: float = 0.0
    burst_factor: float = 4.0
    burst_len_s: float = 5.0
    tenants: int = 0
    tenant_zipf_a: float = 1.2
    tenant_sys_prob: float = 0.75
    tenant_sys_tokens_min: int = 64
    tenant_sys_tokens_max: int = 256

    @classmethod
    def from_dict(cls, d: dict) -> "Mix":
        known = {f.name for f in fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown mix parameters {unknown}")
        return cls(**d)


@dataclass
class Item:
    """One request as the traffic makes it."""
    rid: str
    modality: str
    arrival: float
    text_tokens: int
    mm_units: int
    output_tokens: int
    prompt_tokens: int
    mm_hash: str | None = None
    shared_prefix_id: str | None = None
    shared_prefix_tokens: int = 0
    tenant: str = "default"


def _shape_arrivals(cfg: Mix, gaps, trng):
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


def _tenant_pool(cfg: Mix, mix: dict, trng):
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


def generate(cfg: Mix) -> list[Item]:
    rng = np.random.default_rng(cfg.seed)
    mix = MIXES[cfg.mix]
    modalities = rng.choice(
        ["text", "image", "video"], size=cfg.num_requests,
        p=[mix["text"], mix["image"], mix["video"]])
    gaps = rng.exponential(1.0 / cfg.rate, size=cfg.num_requests)
    arrivals = np.cumsum(gaps)
    trace_on = (cfg.heavy_tail_prob > 0 or cfg.diurnal_amplitude > 0
                or cfg.burst_prob > 0 or cfg.tenants > 0)
    trng = np.random.default_rng(cfg.seed + 0x7ACE) if trace_on else None
    if cfg.diurnal_amplitude > 0 or cfg.burst_prob > 0:
        arrivals = _shape_arrivals(cfg, gaps, trng)
    tenant_specs, tenant_pop = _tenant_pool(cfg, mix, trng)
    reqs = []
    pools: dict[str, list[tuple[str, int]]] = {"image": [], "video": []}
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
            mod = str(trng.choice(["text", "image", "video"], p=tmix))
            if trng.uniform() < cfg.tenant_sys_prob:
                shared_id, shared_toks = sys_id, sys_toks
        out_toks = int(np.clip(rng.lognormal(
            cfg.out_tokens_log_mu, cfg.out_tokens_log_sigma),
            cfg.out_tokens_min, cfg.out_tokens_max))
        if cfg.heavy_tail_prob > 0 and trng.uniform() < cfg.heavy_tail_prob:
            out_toks = min(cfg.heavy_tail_out_cap,
                           int(32 * (1 + trng.pareto(cfg.heavy_tail_alpha))))
        mm_hash = None
        if mod == "text":
            text = int(np.clip(rng.lognormal(
                cfg.text_tokens_log_mu, cfg.text_tokens_log_sigma),
                cfg.text_tokens_min, cfg.text_tokens_max))
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
            text = int(np.clip(rng.lognormal(
                cfg.mm_text_log_mu, cfg.mm_text_log_sigma),
                cfg.mm_text_min, cfg.mm_text_max))
            if cfg.duplicate_prob > 0 and pools[mod] and \
                    rng.uniform() < cfg.duplicate_prob:
                mm_hash, mm = pools[mod][int(rng.integers(len(pools[mod])))]
            else:
                if mod == "image":
                    mm = int(cfg.image_patches *
                             (1 + rng.uniform(-cfg.image_patch_jitter,
                                              cfg.image_patch_jitter)))
                else:
                    frames = int(rng.integers(cfg.video_frames_min,
                                              cfg.video_frames_max + 1))
                    mm = frames * cfg.video_patches_per_frame
                mm_hash = f"{mod}-{i:05d}"
                pools[mod].append((mm_hash, mm))
        if shared_id is not None:
            text += shared_toks
        reqs.append(Item(
            rid=f"r{i:05d}", modality=str(mod), arrival=float(t),
            text_tokens=text, mm_units=mm, output_tokens=out_toks,
            prompt_tokens=text + mm, mm_hash=mm_hash,
            shared_prefix_id=shared_id, shared_prefix_tokens=shared_toks,
            tenant=tenant))
    return reqs


def window(traffic: dict, seed: int, seconds: float,
           rate: float | None = None) -> list[Item]:
    """The requests due in a window of ``seconds``, in arrival order.

    ``traffic`` is a mix file: ``generator`` (``Mix`` parameters, its
    ``rate`` and ``num_requests``, the pool drawn once) and ``base_seed``.
    Every seed gets the pool's sizes and the gaps between its arrivals,
    each shuffled by the seed. Content identities (rids, mm hashes, system prompts) carry the seed, so
    every seed's prompts differ. ``rate`` overrides the file's (the knee
    sweep)."""
    params = dict(traffic["generator"], seed=int(traffic["base_seed"]))
    if rate is not None:
        params["rate"] = rate
    pool = generate(Mix.from_dict(params))
    base = [it for it in pool if it.arrival <= seconds]
    if len(base) == len(pool):
        raise ValueError(f"the mix's pool of {len(pool)} requests ends "
                         f"before {seconds} s: raise num_requests")
    rng = np.random.default_rng(int(seed))
    n = len(base)
    sizes = rng.permutation(n)
    times = np.array([it.arrival for it in base])
    gaps = np.diff(np.concatenate([[0.0], times]))
    times = np.cumsum(gaps[rng.permutation(n)])

    def tag(x):
        return None if x is None else f"s{seed}-{x}"

    out = []
    for j in range(n):
        src = base[sizes[j]]
        out.append(replace(
            src, rid=f"s{seed}r{j:05d}", arrival=float(times[j]),
            mm_hash=tag(src.mm_hash),
            shared_prefix_id=tag(src.shared_prefix_id)))
    return out
