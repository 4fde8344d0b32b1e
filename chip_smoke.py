"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py                # every phase
    python3 chip_smoke.py --profile      # plus where a step's time goes

Phases, each printing its own lines:
  1. the card's name and power limit (nvidia-smi);
  2. build the hand-written CUDA kernels from src/repro_torch/csrc (one
     nvcc per source, all at once), with each kernel's registers and
     spills and each library's count of warpgroup products (HGMMA) in its
     SASS;
  3. the paged kernels against their plain torch versions at qwen2-vl's
     serving shapes (H=12, KV=2, hd=128, page 16), with kernel, plain,
     library (SDPA over the gathered context) and lower-bound times; the
     decode kernel at B=16 (contexts 0..4096), B=1 at 4096 and on lengths
     at every boundary of its split over keys, each with its split plan;
     the prefill kernel with its tile plan, its heaviest block's bound and
     the wrapper's host time a call. Each output must be within TOL of the
     plain version's and, per query token, within REL_RMS of its scale;
  4. prefill_attention against its plain version at gemma3-27b's shapes
     (H=32, KV=16, hd=128; chunks, decodes at B=1 and B=3, sliding window
     1024, a decode past the end of the slot buffer, softcap), with the
     same times (SDPA with a boolean mask and GQA as the library call),
     the same limits, the split plan of each decode and the tile plan of
     each chunk;
  5. serve: full-width qwen2-vl-2b (28 layers, bf16, max_len 4096,
     16 slots, policy tcm) through repro_torch.launch.serve.build_stack —
     real profiler, estimator and classifier — then the engine on an MH
     workload; every request must finish with tokens, both paged kernels
     must have launched, and JAX must not be loaded;
  6. model check: the served weights, cut to two layers, give the same
     logits with attention through the kernels as through their plain
     torch versions, on a small input;
  7. gemma3 serve: full-width gemma3-27b (62 layers, bf16, max_len 2048,
     4 dense slots, policy tcm), which build_stack's "real" mode puts on
     the dense-slot path (sliding window), on 8 MH requests; every request
     must finish with tokens, prefill_attention must have launched and
     neither paged kernel, JAX must not be loaded; peak device memory;
  8. gemma3 model check: the served weights cut to their first 6 layers
     (5 local, 1 global), a 1536-token prompt and one decode step through
     the dense cache, attention through the kernel against its plain
     version;
  9. a JSON line of every kernel's numbers, then the device JSON line last.

``--profile`` adds, after each serve phase, where a serving step's time
goes: a decode step's (qwen2-vl) or decode forward's (gemma3) host
enqueue against enqueue-plus-device time with a profiler table, the same
for a 512-token prefill chunk (qwen2-vl at context 3072, gemma3 at 1536)
with the prefill kernel's share of the device time, and the decode
kernel's time against context length.

Exits non-zero, printing no result, when CUDA is unavailable or the
repository's sources are not beside this script, or when any check fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

H, KV, HD, PAGE = 12, 2, 128, 16          # qwen2-vl-2b
GH, GKV, GMAX, GWIN = 32, 16, 2048, 1024   # gemma3-27b, max_len, window
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
TOL = 2e-2
# and, for each query token, rms error over its (heads, dims) outputs at
# most REL_RMS of the plain output's rms there: a decode over thousands of
# random keys has outputs of ~0.03, which only this limit holds to scale
REL_RMS = 1e-2
# the decode kernel's B=16 case: contexts 0..4096 around page boundaries
DECODE_LENGTHS = [0, 1, 15, 16, 17, 100, 511, 512, 1000, 2048, 2049, 3000,
                  4000, 4095, 4096, 4096]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def print_hgmma(build):
    """Count each library's warpgroup products (HGMMA) in its SASS, where
    the toolkit's cuobjdump is present: the prefill kernels' products run
    on wgmma."""
    tool = Path(build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        print("  cuobjdump not found: HGMMA not counted")
        return
    for name in build.SOURCES:
        sass = subprocess.run([str(tool), "-sass",
                               str(build.library_path(name))],
                              capture_output=True, text=True, timeout=120)
        n = sum("HGMMA" in line for line in sass.stdout.splitlines())
        print(f"  {name}: {n} HGMMA instructions in its SASS", flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(torch, fn, reps: int = 20, flush=None) -> float:
    """Median device time of ``fn`` over ``reps`` launches, each timed by
    its own pair of CUDA events, with the L2 cache flushed before each
    (the serving path finds the pages cold). A short device sleep after
    the flush keeps the card busy while the host enqueues ``fn``, so the
    events time the device work and not the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(2_000_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _pool(torch, gen, n_pages):
    kp = torch.randn((n_pages, PAGE, KV, HD), generator=gen, device="cuda")
    vp = torch.randn((n_pages, PAGE, KV, HD), generator=gen, device="cuda")
    return kp.to(torch.bfloat16), vp.to(torch.bfloat16)


def _tables(torch, gen, B, maxp, n_pages):
    perm = torch.randperm(n_pages, generator=gen, device="cuda")
    return perm[:B * maxp].reshape(B, maxp).to(torch.int32).contiguous()


def _gqa_sdpa(torch, q, k, v, mask):
    """One SDPA call over a gathered context: q (B,H,Sq,hd), k/v
    (B,KV,T,hd), bool mask (B,1,Sq,T)."""
    F = torch.nn.functional
    try:
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)
    except TypeError:
        rep = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1),
            attn_mask=mask)


def compare(out, ref, label):
    """(max abs error, worst per-token relative rms error) of a kernel's
    output against its plain version's; fails past TOL or REL_RMS. Tokens
    whose plain output is all zero (length-0 rows, padding queries) are
    left to the exact-zero checks."""
    d = out.float() - ref.float()
    err = d.abs().max().item()
    rms_d = d.flatten(-2).square().mean(-1).sqrt()
    rms_r = ref.float().flatten(-2).square().mean(-1).sqrt()
    live = rms_r > 0
    rel = (rms_d[live] / rms_r[live]).max().item() if live.any() else 0.0
    if not math.isfinite(err) or err > TOL:
        fail(f"{label}: max_abs_err {err} > {TOL}")
    if not math.isfinite(rel) or rel > REL_RMS:
        fail(f"{label}: rms error {rel} of the plain output's rms > "
             f"{REL_RMS}")
    return err, rel


def boundary_lengths(mod, B):
    """B decode lengths: 255, 256, 257, then every slice boundary of the
    decode kernel's split plan for a 256-page table, then one key past
    each, then full rows."""
    from repro_torch.kernels import split
    T = 4096
    n, chunk = mod.split_plan(B, KV, T, PAGE)
    bounds = [a for a, _ in split.ranges(0, T, n, chunk)[1:]]
    return ([255, 256, 257] + bounds + [b + 1 for b in bounds] +
            [T] * B)[:B]


def check_decode(torch, mod, gen, lengths, flush, label):
    B = len(lengths)
    maxp = 4096 // PAGE
    n_pages = B * maxp + 64
    kp, vp = _pool(torch, gen, n_pages)
    bt = _tables(torch, gen, B, maxp, n_pages)
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = torch.randn((B, H, HD), generator=gen, device="cuda").to(
        torch.bfloat16)
    out = mod.paged_attention(q, kp, vp, bt, ln)
    torch.cuda.synchronize()
    ref = mod.plain(q.float(), kp.float(), vp.float(), bt, ln)
    zero_rows = [i for i, n in enumerate(lengths) if n == 0]
    if zero_rows and out[zero_rows].abs().max().item() != 0.0:
        fail("decode: length-0 rows are not exact zeros")
    err, rel = compare(out, ref, f"decode {label}")
    T = maxp * PAGE
    k_ctx = kp[bt.long()].reshape(B, T, KV, HD).transpose(1, 2)
    v_ctx = vp[bt.long()].reshape(B, T, KV, HD).transpose(1, 2)
    mask = (torch.arange(T, device="cuda")[None, :] <
            ln.long()[:, None])[:, None, None, :]
    qs = q[:, :, None, :]
    ms = time_ms(torch, lambda: mod.paged_attention(q, kp, vp, bt, ln),
                 flush=flush)
    plain_ms = time_ms(torch, lambda: mod.plain(q, kp, vp, bt, ln), reps=5)
    lib_ms = time_ms(torch, lambda: _gqa_sdpa(torch, qs, k_ctx, v_ctx, mask),
                     flush=flush)
    live = sum(lengths)
    bytes_ = (live * KV * HD * 2 * 2 + 2 * q.numel() * 2 + bt.numel() * 4
              + B * 4)
    flops = 4 * live * H * HD
    n, chunk = mod.split_plan(B, KV, maxp * PAGE, PAGE)
    return _row(err, rel, ms, plain_ms, lib_ms, bytes_, flops,
                f"decode {label}, B={B} contexts<= {max(lengths)} "
                f"[split: n_split={n} chunk={chunk} blocks={B * KV * n}]")


def check_prefill(torch, mod, gen, q_start, new_lens, Sq, flush):
    from repro_torch.kernels import tiles
    B = len(q_start)
    maxp = 4096 // PAGE
    n_pages = B * maxp + 64
    kp, vp = _pool(torch, gen, n_pages)
    bt = _tables(torch, gen, B, maxp, n_pages)
    qs_t = torch.tensor(q_start, dtype=torch.int32, device="cuda")
    nl_t = torch.tensor(new_lens, dtype=torch.int32, device="cuda")
    q = torch.randn((B, Sq, H, HD), generator=gen, device="cuda").to(
        torch.bfloat16)
    out = mod.paged_prefill_attention(q, kp, vp, bt, qs_t, nl_t)
    torch.cuda.synchronize()
    ref = mod.plain(q.float(), kp.float(), vp.float(), bt, qs_t, nl_t)
    pad = torch.arange(Sq, device="cuda")[None, :] >= nl_t.long()[:, None]
    if pad.any() and out[pad].abs().max().item() != 0.0:
        fail("prefill: padding queries are not exact zeros")
    err, rel = compare(out, ref, "prefill")
    T = maxp * PAGE
    k_ctx = kp[bt.long()].reshape(B, T, KV, HD).transpose(1, 2)
    v_ctx = vp[bt.long()].reshape(B, T, KV, HD).transpose(1, 2)
    qpos = qs_t.long()[:, None] + torch.arange(Sq, device="cuda")[None, :]
    kpos = torch.arange(T, device="cuda")[None, None, :]
    total = (qs_t + nl_t).long()[:, None, None]
    mask = ((kpos <= qpos[:, :, None]) & (kpos < total))[:, None]
    qt = q.transpose(1, 2)
    ms = time_ms(torch, lambda: mod.paged_prefill_attention(
        q, kp, vp, bt, qs_t, nl_t), flush=flush)
    plain_ms = time_ms(torch, lambda: mod.plain(q, kp, vp, bt, qs_t, nl_t),
                       reps=5)
    lib_ms = time_ms(torch, lambda: _gqa_sdpa(torch, qt, k_ctx, v_ctx, mask),
                     flush=flush)
    live = sum(s + n for s, n in zip(q_start, new_lens))
    pairs = sum((s + i + 1) for s, n in zip(q_start, new_lens)
                for i in range(n))
    bytes_ = (live * KV * HD * 2 * 2 + 2 * q.numel() * 2 + bt.numel() * 4
              + 2 * B * 4)
    flops = 4 * pairs * H * HD
    G = H // KV
    bq, n_tiles = tiles.plan(Sq, G)
    walks = []
    for s, n in zip(q_start, new_lens):
        for t in range(n_tiles):
            last = min((t + 1) * bq, n) - 1     # last real query of the tile
            if last >= t * bq:
                walks.append((min(bq, Sq - t * bq) * G, s + last + 1))
    blk = block_bound_ms(walks)
    host = host_us(torch, lambda: mod.paged_prefill_attention(
        q, kp, vp, bt, qs_t, nl_t))
    row = _row(err, rel, ms, plain_ms, lib_ms, bytes_, flops,
               f"prefill B={B} Sq={Sq} q_start={q_start} "
               f"new_lens={new_lens} [tiles: BQ={bq} x {n_tiles}, "
               f"{n_tiles * B * KV} blocks]")
    print(f"  heaviest block's bound {blk:.4f} ms (one SM's share of the "
          f"peak); wrapper host time {host:.1f} us a call", flush=True)
    return row


SM_COUNT = 132                 # H100 SXM streaming multiprocessors


def block_bound_ms(walks):
    """The least time of the heaviest block of a prefill kernel: its
    bf16 operations (rows x keys walked x 4 hd, both products) over one
    SM's share of the card's peak. ``walks`` lists (rows, keys) per block.
    A kernel that never splits a block's keys cannot go below it."""
    rows, keys = max(walks, key=lambda w: w[0] * w[1])
    return 4 * rows * keys * HD / (BF16_FLOPS_PER_S / SM_COUNT) * 1e3


def host_us(torch, fn, reps=200):
    """Host time of one call of ``fn`` (enqueue only; no sync inside)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return us


def _row(err, rel, ms, plain_ms, lib_ms, bytes_, flops, label):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": lib_ms}
    lib = "null" if lib_ms is None else f"{lib_ms:.4f}"
    print(f"{label}: max_err={err:.3e} rel_rms_err={rel:.3e} "
          f"kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={lib} "
          f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}; "
          f"{bytes_} bytes, {flops} flops)", flush=True)
    return row


def dense_work(B, Sq, n_keys, q_start, window):
    """(bytes, flops) the dense attention needs at gemma3's widths for B
    sequences: q read and out written once, each key some query sees read
    once (K and V), and the two products over the visible (query, key)
    pairs (a row that sees no key averages over all of them)."""
    qpos = q_start + np.arange(Sq)
    hi = np.minimum(n_keys, qpos + 1)
    lo = np.maximum(0, qpos - window + 1) if window > 0 else \
        np.zeros_like(qpos)
    none = lo >= hi
    lo, hi = np.where(none, 0, lo), np.where(none, n_keys, hi)
    pairs = int((hi - lo).sum())
    keys = int(hi.max() - lo.min())
    bytes_ = 2 * Sq * GH * HD * 2 + 2 * keys * GKV * HD * 2
    return B * bytes_, B * 4 * pairs * GH * HD


def check_dense(torch, mod, gen, B, Sq, n_keys, q_start, window, softcap,
                flush, label):
    """prefill_attention at gemma3's shapes: q (B, Sq, 32, 128); K/V the
    first n_keys rows of a (B, 2048, 16, 128) slot buffer (a separate
    (B, Sq, 16, 128) pair for the cache-less case, n_keys == Sq)."""
    from repro_torch.kernels import tiles
    S = max(n_keys, GMAX) if n_keys != Sq else n_keys
    q = torch.randn((B, Sq, GH, HD), generator=gen, device="cuda").to(
        torch.bfloat16)
    kb = torch.randn((B, S, GKV, HD), generator=gen, device="cuda").to(
        torch.bfloat16)
    vb = torch.randn((B, S, GKV, HD), generator=gen, device="cuda").to(
        torch.bfloat16)
    k, v = kb[:, :n_keys], vb[:, :n_keys]
    kw = dict(q_start=q_start, window=window, softcap=softcap)
    out = mod.prefill_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = mod.plain(q.float(), k.float(), v.float(), **kw)
    err, rel = compare(out, ref, f"prefill_attention {label}")
    ms = time_ms(torch, lambda: mod.prefill_attention(q, k, v, **kw),
                 flush=flush)
    plain_ms = time_ms(torch, lambda: mod.plain(q, k, v, **kw), reps=5)
    lib_ms = None
    if softcap == 0.0:       # SDPA has no softcap: no library call for it
        from repro_torch.kernels.ref import causal_mask
        mask = causal_mask(q_start, Sq, n_keys, window, device="cuda")
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lib_ms = time_ms(torch, lambda: _gqa_sdpa(torch, qt, kt, vt, mask),
                         flush=flush)
    bytes_, flops = dense_work(B, Sq, n_keys, q_start, window)
    host = host_us(torch, lambda: mod.prefill_attention(q, k, v, **kw))
    blk = None
    if mod.decode_route(q, k, v):
        lo, hi = mod.key_range(n_keys, Sq, q_start, window)
        n, chunk = mod.split_plan(B, GKV, lo, hi)
        route = (f"decode route, split: keys [{lo}, {hi}) n_split={n} "
                 f"chunk={chunk} blocks={B * GKV * n}")
    else:
        bq, n_tiles = tiles.plan(Sq, GH // GKV)
        route = (f"chunk route, tiles: BQ={bq} x {n_tiles}, "
                 f"{n_tiles * B * GKV} blocks")
        walks = []
        for t in range(n_tiles):
            q0, q1 = t * bq, min(Sq, (t + 1) * bq)
            lo, hi = mod.key_range(n_keys, q1 - q0, q_start + q0, window)
            walks.append(((q1 - q0) * (GH // GKV), hi - lo))
        blk = block_bound_ms(walks)
    row = _row(err, rel, ms, plain_ms, lib_ms, bytes_, flops,
               f"prefill_attention {label}: B={B} Sq={Sq} n_keys={n_keys} "
               f"q_start={q_start} window={window} softcap={softcap} "
               f"[{route}]")
    if blk is not None:
        print(f"  heaviest block's bound {blk:.4f} ms (one SM's share of "
              f"the peak)", flush=True)
    print(f"  wrapper host time {host:.1f} us a call", flush=True)
    return row


# ---------------------------------------------------------------------------
# phases 4-5: serve at full width, then the model check
# ---------------------------------------------------------------------------

def serve_phase(torch, n_requests: int, breakdown: bool):
    from repro_torch.kernels import ops
    from repro_torch.core.scheduler import make_policy
    from repro_torch.launch.serve import build_stack
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.metrics import fmt_table, summarize
    from repro_torch.serving.request import State
    from repro_torch.serving.workload import WorkloadConfig, generate

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    executor, classifier, engine_cfg, profile, _ = build_stack(
        "qwen2-vl-2b", "real", full=True, max_len=4096, device="cuda")
    t_build = time.perf_counter() - t0
    cfg = executor.cfg
    print(f"model {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, H={cfg.num_heads}, KV={cfg.num_kv_heads}, "
          f"hd={cfg.hd}, vocab {cfg.vocab_size}, dtype {cfg.dtype}; "
          f"attn_impl={executor.attn_impl}; stack built (warm-up, "
          f"{len(profile.records)} profiled requests, estimator, "
          f"classifier) in {t_build:.2f}s", flush=True)
    if cfg.num_layers != 28 or cfg.d_model != 1536:
        fail("serve: not the full-width qwen2-vl-2b")
    reqs = generate(WorkloadConfig(mix="MH", rate=4.0,
                                   num_requests=n_requests, seed=0))
    engine = Engine(make_policy("tcm"), executor, classifier, engine_cfg)
    spent = {}
    if breakdown:
        # time every forward step, synchronised (adds a sync per step)
        step = executor._step

        def timed_step(tokens, *args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(tokens, *args)
            torch.cuda.synchronize()
            key = "decode" if tokens.shape[1] == 1 else "prefill"
            n, sec = spent.get(key, (0, 0.0))
            spent[key] = (n + 1, sec + time.perf_counter() - t)
            return out
        executor._step = timed_step
    t1 = time.perf_counter()
    done = engine.run(reqs)
    torch.cuda.synchronize()
    if breakdown:
        executor._step = step
        for key, (n, sec) in sorted(spent.items()):
            print(f"serve breakdown: {n} {key} steps, {sec:.3f}s, "
                  f"{sec / n * 1e3:.2f} ms each")
    t_run = time.perf_counter() - t1
    counts = ops.launch_counts()
    mods = {}
    for r in reqs:
        mods[r.modality.value] = mods.get(r.modality.value, 0) + 1
    tokens = {r.rid: len(executor.emitted.get(r.rid, [])) for r in reqs}
    print(fmt_table(summarize(done), f"qwen2-vl-2b (full) | tcm | MH | "
                                     f"{n_requests} requests {mods}"))
    n_tok = sum(tokens.values())
    print(f"serve: {len(done)}/{len(reqs)} finished, "
          f"{engine.iterations} iterations, {n_tok} tokens in "
          f"{t_run:.2f}s wall = {n_tok / t_run:.1f} tokens/s; "
          f"launches {counts}; prompt tokens "
          f"{sorted(r.prompt_tokens for r in reqs)}", flush=True)
    unfinished = [r.rid for r in reqs if r.state is not State.FINISHED]
    if unfinished:
        fail(f"serve: requests not finished: {unfinished}")
    empty = [rid for rid, n in tokens.items() if n == 0]
    if empty:
        fail(f"serve: requests with no tokens: {empty}")
    for name in ("paged_attention", "paged_prefill_attention"):
        if counts[name] <= 0:
            fail(f"serve: kernel {name} never launched on the main path")
    if "jax" in sys.modules:
        fail("serve: jax was imported")
    return executor, counts


class PlainOps:
    """``kernels.ops`` with every kernel replaced by its plain torch
    version, on the card (swapped into ``models.layers`` for a check)."""

    @staticmethod
    def paged_attention(*args, **kw):
        from repro_torch.kernels import paged_attention as mod
        return mod.plain(*args, **kw)

    @staticmethod
    def paged_prefill_attention(*args, **kw):
        from repro_torch.kernels import paged_prefill_attention as mod
        return mod.plain(*args, **kw)

    @staticmethod
    def prefill_attention(*args, **kw):
        from repro_torch.kernels import prefill_attention as mod
        return mod.plain(*args, **kw)


def model_check(torch, executor, depth=2):
    """The served full-width weights, cut to their first ``depth`` layers,
    on a small input (a 96-token prefill chunk, then one decode step):
    the forward through the kernels against the same forward with
    attention through the kernels' plain torch versions, on the same
    device. With these random weights the attention logits are large
    (std ~100), so softmax is nearly one-hot and a comparison against a
    differently rounded attention (bf16 logits, as the gather path and
    the JAX package compute them) flips keys; the plain versions round as
    the kernels do (f32 logits), so the two paths differ only in
    summation order and the P rounding of the tensor-core path."""
    import dataclasses

    from repro_torch.cache.paged import PagedStackStore
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    full = executor.cfg
    if full.stages() != [((full.pattern()[0],), full.num_layers)]:
        fail("model check: expected one stacked stage")
    B, C, ppl = 2, 96, 16        # 2 rows x 7 pages, trash page 15
    gen = torch.Generator(device="cpu").manual_seed(7)
    toks = torch.randint(1, full.vocab_size, (B, C + 1), generator=gen)
    bt = torch.tensor([[i * 7 + j for j in range(7)] for i in range(B)],
                      dtype=torch.int32, device="cuda")
    cfg = dataclasses.replace(full, num_layers=depth)
    layers = [{"b0": executor.layers[0]["b0"][:depth]}]
    outs = {}
    kernel_ops = L.kops
    for name, ops in (("kernel", kernel_ops), ("plain", PlainOps)):
        stores = [{f"b{i}": PagedStackStore.build(
            reps, ppl, PAGE, cfg.num_kv_heads, cfg.hd, device="cuda")
            for i, _ in enumerate(period)} for period, reps in cfg.stages()]
        logits = []
        L.kops = ops
        try:
            for start, n in ((0, C), (C, 1)):
                new_lens = torch.tensor([n, n], dtype=torch.int32,
                                        device="cuda")
                cache = {"stages": stores, "block_table": bt,
                         "lengths": torch.full((B,), start,
                                               dtype=torch.int32,
                                               device="cuda"),
                         "new_lens": new_lens}
                pos = (start + torch.arange(n, device="cuda"))[None].expand(
                    B, n)
                with torch.no_grad():
                    lg, _, _ = T.forward(
                        executor.params, cfg,
                        toks[:, start:start + n].cuda(), positions=pos,
                        cache=cache, attn_impl="kernel",
                        last_pos=new_lens - 1, layers=layers)
                logits.append(lg.float())
        finally:
            L.kops = kernel_ops
        outs[name] = torch.cat(logits, dim=1)
    a, b = outs["kernel"], outs["plain"]
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        fail("model check: non-finite logits")
    err = (a - b).abs().max().item()
    excess = ((a - b).abs() - (0.1 + 0.1 * b.abs())).max().item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    print(f"model check (full width, first {depth} layers, prefill {C} + "
          f"decode 1, B={B}; kernels vs their plain versions in the "
          f"forward): logits {tuple(a.shape)}, max|diff| {err:.4f} of "
          f"max|logit| {b.abs().max().item():.4f}, argmax agreement "
          f"{agree:.2f}", flush=True)
    if excess > 0:
        fail("model check: kernel path outside atol 0.1 + rtol 0.1 of the "
             "plain path")


def gemma_serve_phase(torch, n_requests: int):
    """Full-width gemma3-27b through build_stack's real mode, which puts
    it on the dense-slot path (sliding-window attention is outside the
    paged protocol), then the engine on an MH workload. The engine admits
    by pages, so its KV pages are only accounting here (the slot caches
    hold the KV): kv_pages is sized so that no prompt is rejected. One
    slot stays free of running requests (max_num_seqs = max_slots - 1):
    an arriving request's admission-time isolated run takes a slot."""
    from repro_torch.core.scheduler import make_policy
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_stack
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.metrics import fmt_table, summarize
    from repro_torch.serving.request import State
    from repro_torch.serving.workload import WorkloadConfig, generate

    slots = 4
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    executor, classifier, engine_cfg, profile, _ = build_stack(
        "gemma3-27b", "real", full=True, max_len=GMAX, max_slots=slots,
        kv_pages=4096, device="cuda")
    t_build = time.perf_counter() - t0
    cfg = executor.cfg
    print(f"model {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, H={cfg.num_heads}, KV={cfg.num_kv_heads}, "
          f"hd={cfg.hd}, window {cfg.sliding_window}, vocab "
          f"{cfg.vocab_size}, dtype {cfg.dtype}; legacy={executor.legacy}, "
          f"{executor.max_slots} slots at max_len {executor.max_len}; "
          f"stack built (weights, warm-up, {len(profile.records)} profiled "
          f"requests, estimator, classifier) in {t_build:.2f}s; device "
          f"memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    if cfg.num_layers != 62 or cfg.d_model != 5376 or not executor.legacy:
        fail("gemma3 serve: not the full-width gemma3-27b on the dense path")
    engine_cfg = dataclasses.replace(engine_cfg, max_num_seqs=slots - 1)
    reqs = generate(WorkloadConfig(mix="MH", rate=2.0,
                                   num_requests=n_requests, seed=0))
    engine = Engine(make_policy("tcm"), executor, classifier, engine_cfg)
    t1 = time.perf_counter()
    done = engine.run(reqs)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t1
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = {r.rid: len(executor.emitted.get(r.rid, [])) for r in reqs}
    print(fmt_table(summarize(done), f"gemma3-27b (full) | tcm | MH | "
                                     f"{n_requests} requests"))
    n_tok = sum(tokens.values())
    print(f"gemma3 serve: {len(done)}/{len(reqs)} finished, "
          f"{engine.iterations} iterations, {n_tok} tokens in "
          f"{t_run:.2f}s wall = {n_tok / t_run:.1f} tokens/s; launches "
          f"{counts}; peak device memory {peak / 2**30:.2f} GiB "
          f"({peak} bytes); prompt tokens "
          f"{sorted(r.prompt_tokens for r in reqs)}", flush=True)
    unfinished = [r.rid for r in reqs if r.state is not State.FINISHED]
    if unfinished:
        fail(f"gemma3 serve: requests not finished: {unfinished}")
    empty = [rid for rid, n in tokens.items() if n == 0]
    if empty:
        fail(f"gemma3 serve: requests with no tokens: {empty}")
    if counts["prefill_attention"] <= 0:
        fail("gemma3 serve: prefill_attention never launched")
    for name in ("paged_attention", "paged_prefill_attention"):
        if counts[name] != 0:
            fail(f"gemma3 serve: the paged kernel {name} launched")
    if "jax" in sys.modules:
        fail("gemma3 serve: jax was imported")
    return executor, counts


class CheckedOps:
    """``kernels.ops`` for a check inside the forward: each
    ``prefill_attention`` call runs the kernel and its plain version on the
    same inputs, records how far apart they are, and returns the plain
    output, so every layer of the check sees the same inputs."""

    def __init__(self):
        self.calls = []

    def prefill_attention(self, q, k, v, **kw):
        from repro_torch.kernels import prefill_attention as mod
        a = mod.prefill_attention(q, k, v, **kw).float()
        b = mod.plain(q, k, v, **kw)
        d, bf = (a - b.float()), b.float()
        self.calls.append((tuple(q.shape), kw.get("window", 0),
                           (d.square().mean().sqrt()
                            / bf.square().mean().sqrt()).item(),
                           (d.abs().max() / bf.abs().max()).item()))
        return b


def gemma_model_check(torch, executor, depth=6, prompt=1536):
    """The served full-width gemma3 weights cut to their first ``depth``
    layers (one period: 5 sliding-window, 1 global) on a ``prompt``-token
    prefill and one decode step through a dense slot cache.

    Gate: inside that forward, every ``prefill_attention`` call (each
    layer, both steps) runs the kernel and its plain version on the same
    inputs; their outputs must agree within rms 1e-2 and max 5e-2 of the
    plain output's rms and max. Reported, not gated: the logits of the
    forward with attention through the kernel against the forward through
    the plain version. With these random weights the attention logits
    have a std of ~170 (q and k elements ~13), so softmax rows are nearly
    one-hot and a row whose top two keys nearly tie picks a different key
    on a last-bit difference; one layer's bf16-level difference grows
    ~10x per layer over 1536 tokens, so the two free-running forwards part
    whatever the kernel's accuracy."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    full = executor.cfg
    cfg = dataclasses.replace(full, num_layers=depth)
    if cfg.pattern() != full.pattern()[:depth]:
        fail("gemma3 model check: the cut is not the model's first layers")
    # the served layers in model order, regrouped into the cut's stages
    order = iter([executor.layers[si][f"b{bi}"][li]
                  for si, (period, reps) in enumerate(full.stages())
                  for li in range(reps) for bi in range(len(period))])
    layers = []
    for period, reps in cfg.stages():
        per = {f"b{bi}": [] for bi in range(len(period))}
        for _ in range(reps):
            for bi in range(len(period)):
                per[f"b{bi}"].append(next(order))
        layers.append(per)
    gen = torch.Generator(device="cpu").manual_seed(11)
    toks = torch.randint(1, full.vocab_size, (1, prompt + 1),
                         generator=gen).cuda()
    checked = CheckedOps()
    outs = {}
    kernel_ops = L.kops
    for name, ops in (("kernel", kernel_ops), ("plain", PlainOps),
                      ("checked", checked)):
        cache = T.init_cache(cfg, 1, GMAX, device="cuda")
        logits = []
        L.kops = ops
        try:
            for start, n in ((0, prompt), (prompt, 1)):
                with torch.no_grad():
                    lg, cache, _ = T.forward(
                        executor.params, cfg, toks[:, start:start + n],
                        cache=cache, q_start=start, last_only=True,
                        layers=layers)
                logits.append(lg.float())
        finally:
            L.kops = kernel_ops
        outs[name] = torch.cat(logits, dim=1)
    if not all(torch.isfinite(o).all() for o in outs.values()):
        fail("gemma3 model check: non-finite logits")
    for shape, window, rel_rms, rel_max in checked.calls:
        print(f"  prefill_attention in the forward, q {shape}, window "
              f"{window}: kernel vs plain rms {rel_rms:.2e}, max "
              f"{rel_max:.2e} (relative to the plain output)")
    a, b = outs["kernel"], outs["plain"]
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    print(f"gemma3 model check (full width, first {depth} layers "
          f"{cfg.pattern()}, prefill {prompt} + decode 1 through the dense "
          f"cache): {len(checked.calls)} prefill_attention calls checked; "
          f"free-running forwards, kernel vs plain: last-position logits "
          f"{tuple(a.shape)}, max|diff| {(a - b).abs().max().item():.4f} "
          f"of max|logit| {b.abs().max().item():.4f}, argmax agreement "
          f"{agree:.2f}", flush=True)
    if len(checked.calls) != 2 * depth:
        fail("gemma3 model check: not every layer's attention was checked")
    bad = [c for c in checked.calls if not (c[2] <= 1e-2 and c[3] <= 5e-2)]
    if bad:
        fail(f"gemma3 model check: kernel and plain version part inside "
             f"the forward: {bad}")


def profile_phase(torch, executor):
    """Where a serving step's time goes (``--profile`` only): a B=16
    decode step at context 2000 through the executor's own step, its host
    enqueue time against enqueue-plus-device time and a profiler table of
    its device time; then the decode kernel's time against context length
    at B=1 (its cost per 64-key tile)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import paged_attention as dec
    B, C = 16, 2000
    alloc = executor.allocator
    rids = [f"__profile_step_{i}" for i in range(B)]
    for rid in rids:
        alloc.allocate(rid, C + 8)
    try:
        bt = executor._block_table_rows(
            rids, executor._bucket_pages(-(-(C + 1) // PAGE)))
        args = (np.ones((B, 1), np.int32), np.full((B, 1), C, np.int32), bt,
                np.full((B,), C, np.int32), np.ones((B,), np.int32))
        for _ in range(3):
            executor._step(*args)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(10):
            executor._step(*args)
        host = (time.perf_counter() - t) / 10
        torch.cuda.synchronize()
        total = (time.perf_counter() - t) / 10
        print(f"decode step B={B} context {C}: host enqueue "
              f"{host * 1e3:.2f} ms, enqueue+device {total * 1e3:.2f} ms")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                executor._step(*args)
            torch.cuda.synchronize()
        print("3 decode steps:")
        print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                        row_limit=12))
    finally:
        for rid in rids:
            alloc.free(rid)
    gen = torch.Generator(device="cuda").manual_seed(1)
    kp, vp = _pool(torch, gen, 300)
    bt = _tables(torch, gen, 1, 4096 // PAGE, 300)
    q = torch.randn((1, H, HD), generator=gen, device="cuda").to(
        torch.bfloat16)
    for n in (64, 256, 1024, 4096):
        ln = torch.tensor([n], dtype=torch.int32, device="cuda")
        ms = time_ms(torch, lambda: dec.paged_attention(q, kp, vp, bt, ln))
        print(f"decode kernel B=1 context {n}: {ms:.4f} ms")


def device_share(prof, names):
    """(device us of the kernels whose name holds one of ``names``, all
    device us) over a profile's self device times."""
    from torch.autograd import DeviceType

    def dev(e):
        t = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if t is None else t
    # the device's own events (kernels, copies): an operator's row repeats
    # the time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    total = sum(dev(e) for e in events)
    mine = sum(dev(e) for e in events if any(n in e.key for n in names))
    return mine, total


# the prefill kernels' names in the profiler's tables: the wgmma walks and
# the mma.sync kernels they replaced, so that a tree before them reads too
PAGED_PREFILL_KERNELS = ("paged_prefill_wgmma_kernel",
                         "paged_prefill_mma_kernel")
DENSE_CHUNK_KERNELS = ("dense_wgmma_kernel", "dense_mma_kernel")


def timed_steps(torch, step, n):
    """(host enqueue, enqueue plus device) seconds per call of ``step``."""
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        step()
    host = (time.perf_counter() - t) / n
    torch.cuda.synchronize()
    return host, (time.perf_counter() - t) / n


def profile_table(torch, step, label, kernels):
    """A profiler table of three calls of ``step``, and the device share of
    ``kernels``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    print(f"3 {label}:")
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=12))
    mine, total = device_share(prof, kernels)
    print(f"{label}: device time {total / 3e3:.3f} ms a call, the "
          f"attention kernel {mine / 3e3:.3f} ms ({mine / max(total, 1e-9):.1%}"
          f" of it)", flush=True)


def prefill_profile_phase(torch, executor):
    """Where a qwen2-vl prefill step's time goes (``--profile`` only): one
    512-token chunk at context 3072 (keys to 3584) through the executor's
    own step, host enqueue against enqueue-plus-device time, and a
    profiler table with the paged prefill kernel's share of the device
    time. TTFT can follow the kernel only where the device, not the host,
    sets the step's time."""
    C, S = 3072, 512
    alloc = executor.allocator
    rid = "__profile_prefill"
    alloc.allocate(rid, C + S + 8)
    try:
        bt = executor._block_table_rows(
            [rid], executor._bucket_pages(-(-(C + S) // PAGE)))
        gen = np.random.default_rng(3)
        args = (gen.integers(1, executor.cfg.vocab_size, (1, S)).astype(
                    np.int32),
                (C + np.arange(S, dtype=np.int32))[None], bt,
                np.full((1,), C, np.int32), np.full((1,), S, np.int32))

        def step():
            executor._step(*args)
        host, total = timed_steps(torch, step, 10)
        print(f"prefill step B=1 chunk {S} at context {C}: host enqueue "
              f"{host * 1e3:.2f} ms, enqueue+device {total * 1e3:.2f} ms")
        profile_table(torch, step, "prefill steps", PAGED_PREFILL_KERNELS)
    finally:
        alloc.free(rid)


def gemma_prefill_profile_phase(torch, executor):
    """The same for gemma3 (``--profile`` only): one request's 512-query
    chunk forward at context 1536 over a slot cache (keys to 2048)."""
    from repro_torch.models.params import tree_leaves
    cache = executor.caches[0]
    C, S = 1536, 512
    gen = torch.Generator(device="cpu").manual_seed(4)
    toks = torch.randint(1, executor.cfg.vocab_size, (1, S),
                         generator=gen).cuda()

    def step():
        cache["idx"].fill_(C)
        executor._legacy_forward(toks, None, cache, C)
    host, total = timed_steps(torch, step, 5)
    print(f"gemma3 chunk forward {S} queries at context {C}: host enqueue "
          f"{host * 1e3:.2f} ms, enqueue+device {total * 1e3:.2f} ms")
    profile_table(torch, step, "gemma3 chunk forwards", DENSE_CHUNK_KERNELS)
    for leaf in tree_leaves(cache, torch.is_tensor):
        leaf.zero_()


def gemma_profile_phase(torch, executor):
    """Where a gemma3 decode token's time goes (``--profile`` only): one
    request's decode forward at context 2000 over a slot cache, host
    enqueue against enqueue-plus-device time, and a profiler table of its
    device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.params import tree_leaves
    cache = executor.caches[0]
    tok = torch.ones((1, 1), dtype=torch.int64, device="cuda")

    def step():
        cache["idx"].fill_(2000)
        executor._legacy_forward(tok, None, cache, 2000)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(5):
        step()
    host = (time.perf_counter() - t) / 5
    torch.cuda.synchronize()
    total = (time.perf_counter() - t) / 5
    print(f"gemma3 decode forward at context 2000: host enqueue "
          f"{host * 1e3:.2f} ms, enqueue+device {total * 1e3:.2f} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    print("3 gemma3 decode forwards:")
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=12))
    for leaf in tree_leaves(cache, torch.is_tensor):
        leaf.zero_()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also print where a serving step's time goes")
    args = ap.parse_args()
    if not (SRC / "repro_torch").is_dir():
        fail(f"the port's sources are not beside this script ({SRC})")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    phase("card")
    card = card_line()
    print(card)     # name, power limit: as nvidia-smi gives them
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    phase("build")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build(verbose=True)
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.2f}s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")
    print_hgmma(build)

    phase("kernels vs plain")
    from repro_torch.kernels import paged_attention as dec
    from repro_torch.kernels import paged_prefill_attention as pre
    from repro_torch.kernels import prefill_attention as dense
    gen = torch.Generator(device="cuda").manual_seed(0)
    scratch = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()
    rows = {}
    check_decode(torch, dec, gen, [4096], flush, "B=1 context 4096")
    rows["paged_attention"] = check_decode(
        torch, dec, gen, DECODE_LENGTHS, flush, "B=16 mixed")
    check_decode(torch, dec, gen, boundary_lengths(dec, 16), flush,
                 "split boundaries")
    rows["paged_prefill_attention"] = check_prefill(
        torch, pre, gen, [0, 1024, 3584, 0], [512, 300, 512, 0], 512, flush)

    phase("prefill_attention vs plain")
    dense_rows = {label: check_dense(torch, dense, gen, *case, flush, label)
                  for label, case in (
                      ("chunk", (1, 512, 2048, 1536, 0, 0.0)),
                      ("chunk, window", (1, 512, 2048, 1536, GWIN, 0.0)),
                      ("decode", (1, 1, 2048, 2047, 0, 0.0)),
                      ("decode, window", (1, 1, 2048, 2047, GWIN, 0.0)),
                      ("decode B=3", (3, 1, 2048, 2047, 0, 0.0)),
                      ("decode B=3, window", (3, 1, 2048, 2047, GWIN, 0.0)),
                      ("cache-less", (1, 1536, 1536, 0, 0, 0.0)),
                      ("decode past the buffer, window",
                       (1, 1, 2048, 2100, GWIN, 0.0)),
                      ("chunk, softcap", (1, 512, 2048, 1536, 0, 50.0)))}
    rows["prefill_attention"] = dict(dense_rows["chunk"], **{
        f"decode_{key}": dense_rows["decode"][src] for key, src in (
            ("kernel_ms", "ms"), ("plain_ms", "plain_ms"),
            ("bound_ms", "bound_ms"), ("library_ms", "library_ms"),
            ("max_err", "max_abs_err"))})

    del scratch

    phase("serve")
    executor, counts = serve_phase(torch, 20, breakdown=args.profile)
    phase("model check")
    model_check(torch, executor)
    if args.profile:
        phase("profile")
        profile_phase(torch, executor)
        prefill_profile_phase(torch, executor)
    del executor          # free qwen2-vl before gemma3-27b's 57 GB
    gc.collect()
    torch.cuda.empty_cache()

    phase("gemma3 serve")
    g_executor, g_counts = gemma_serve_phase(torch, 8)
    phase("gemma3 model check")
    gemma_model_check(torch, g_executor)
    if args.profile:
        phase("gemma3 profile")
        gemma_profile_phase(torch, g_executor)
        gemma_prefill_profile_phase(torch, g_executor)
    del g_executor
    gc.collect()
    torch.cuda.empty_cache()

    kernels = [
        dict(name="paged_attention", route="cuda",
             source="src/repro_torch/csrc/paged_attention.cu",
             replaces="src/repro/kernels/paged_attention.py:78",
             launches=counts["paged_attention"],
             **rows["paged_attention"]),
        dict(name="paged_prefill_attention", route="cuda",
             source="src/repro_torch/csrc/paged_prefill_attention.cu",
             replaces="src/repro/kernels/paged_prefill_attention.py:91",
             launches=counts["paged_prefill_attention"],
             **rows["paged_prefill_attention"]),
        dict(name="prefill_attention", route="cuda",
             source="src/repro_torch/csrc/prefill_attention.cu",
             replaces="src/repro/kernels/prefill_attention.py:69",
             launches=g_counts["prefill_attention"],
             **rows["prefill_attention"]),
    ]
    print(f"total {time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
