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
     each chunk; then the shapes the other families bring: the paged
     kernels at phi3.5-moe's GQA group 4 (H=32, KV=8) and at the
     published head groups of chatglm3-6b (32/2, G=16), deepseek-coder-33b
     (56/8, G=7), qwen1.5-110b (64/8, G=8) and grok-1-314b (48/8, G=6,
     softcap 30), all at hd 128 and qwen2-vl's serving lengths, and
     prefill_attention at whisper-base's (H = KV = 8, hd 64) and jamba's
     (H=64, KV=8) attention;
  5. serve: full-width qwen2-vl-2b (28 layers, bf16, max_len 4096,
     16 slots, policy tcm) through repro_torch.launch.serve.build_stack —
     real profiler, estimator and classifier — then the engine on an MH
     workload; every request must finish with tokens, both paged kernels
     must have launched, and JAX must not be loaded;
  6. model check: the served weights cut to two layers, a 96-token
     prefill and one decode step through the paged cache; each attention
     call of that forward runs the kernel and its plain version on the
     same inputs, which must agree;
  7. fleet migration: three replicas of the served qwen2-vl-2b (weights
     shared, each with its own paged stores and allocator): a video of 784
     mm units and 32 text tokens prefills on the source until it decodes,
     its 49-page chain migrates with the payload bytes, the target
     finishes it; the target's pages must hold the bytes the source sent,
     both paged kernels must launch on the target, no page may stay in
     use, and the tokens (and the first one's logits) must equal, bit for
     bit, those of an oracle replica that ran the same step shapes (the
     chain published by two earlier requests with the same video, then
     the same rid claims it and prefills the same 32-token residual);
  8. fleet serve: a Fleet of three replicas, least-loaded routing, 16 MH
     requests at 4 req/s with duplicates and shared prefixes; replica 0
     drains from request 6's arrival at the first tick its move would
     land fresh pages on whichever live peer it picks, replica 2 is
     killed at request 10's arrival and restarts 1 s later warmed from
     a peer; the conservation audit of
     benchmarks/fleet_tolerance.py must read zero, every request must
     finish, the drain must migrate payload pages and the warm import ship
     payload;
  9. legacy parity: full-width chatglm3-6b (28 layers, bf16) through
     build_stack with a 24-page pool, q/k/v at fan-in D, on the mix of
     benchmarks/prefix_cache.py's measure_real_parity (10 ML requests,
     seed 7, duplicates and shared prefixes, one forced preemption) three
     ways: the batched executor with the prefix cache on and off and the
     real-legacy dense-slot oracle, on the "gather" route (mha, no kernel)
     and the "kernel" route (both paged kernels; prefill_attention on the
     dense side). Every run must finish every request with tokens, keep
     the allocator's invariants and preempt (the cache-on run must hit
     the prefix cache); on "gather" every stream must agree but at a
     printed rounding tie (TIE_ULPS); the kernel route's partings are
     printed;
 10. gemma3 serve: full-width gemma3-27b (62 layers, bf16, max_len 2048,
     4 dense slots, policy tcm), which build_stack's "real" mode puts on
     the dense-slot path (sliding window), on 8 MH requests; every request
     must finish with tokens, prefill_attention must have launched and
     neither paged kernel, JAX must not be loaded; peak device memory;
 11. gemma3 model check: the served weights cut to their first 6 layers
     (5 local, 1 global), a 1536-token prompt and one decode step through
     the dense cache, attention through the kernel against its plain
     version;
 12. phi3.5-moe serve: full width (d_model 4096, 16 experts top-2, GQA
     32/8) at 24 of its 32 layers (the bf16 weights of all 32 fill the
     card), random weights, through launch.serve.build_stack on the
     batched paged path (max_len 4096), 12 MH requests at 2 req/s; both
     paged kernels must have launched;
 13. phi3.5-moe model check: a 2-layer cut of the served weights, each
     attention call of its paged forward against the kernel's plain
     version, as in 6; then layer 0's moe_block over a 512-token chunk in bf16 on
     the card against f32 on the CPU (routing identical, each token within
     2e-2 of its rms), with the tokens dropped by capacity;
 14. jamba serve: full width (d_model 8192, GQA 64/8, 16 experts top-2,
     d_ff 24576, Mamba DI 16384) at 5 of its 72 layers (the published
     pattern's first five: Mamba, Mamba+MoE, Mamba, Mamba+MoE, attention;
     one whole 8-layer period does not fit the card), random weights,
     through build_stack on the dense-slot path (6 MH requests),
     prefill_attention launched; then the served layer 0's mamba_block, a
     512-token prefill and 8 decode steps, in f32 on the card against f32
     on the CPU (within 1e-4), and in bf16 on the card no further from
     that reference than bf16 on the CPU is;
 15. whisper-base (6+6 layers, d 512, hd 64) and xlstm-125m (12 layers), full
     width and depth, on the dense-slot path (8 and 6 MH requests);
     whisper must launch prefill_attention, xlstm no kernel;
 16. the four attention and MoE decoders not served above, each at its
     published width and head groups on the batched paged path
     (max_len 4096, 8 MH requests at 2 req/s): chatglm3-6b whole (28
     layers), deepseek-coder-33b whole (62 layers, 66.7 GB, with 1024 KV
     pages: four 4096-token windows, so max_num_seqs 4), qwen1.5-110b at
     20 of 80 layers and grok-1-314b at 6 of 64 (8 experts top-2, d_ff
     32768, softcap 30); each must finish every request with tokens,
     launch both paged kernels and not prefill_attention, and pass the
     model check of 6; grok-1 also the moe_block check of 13. Each prints
     the split and tile plans its kernels took;
 17. train check: full-width qwen2-vl-2b cut to 2 layers (f32 masters
     from a seed, q/k/v at fan-in D), one train_step on the card and on
     the CPU (B=1, S=256 with a 128-unit stub image at M-RoPE positions),
     in f32 (loss, grad norm, every gradient leaf within 1e-3 of its max,
     parameters within 2 lr) and in bf16 (the card no further from the
     CPU's f32 than the CPU's bf16 is); prefill_attention on a query that
     requires grad must raise;
 18. train qwen2-vl-2b: full width and depth (1.777 B parameters, f32
     masters and moments, bf16 compute), 5 train steps at B=2, S=1024
     with a 512-unit stub image, then two with remat; each step's loss,
     grad norm, lr, seconds, tokens/s and peak device memory;
 19. train xlstm-125m: the training launcher with its default arch at
     full size, 20 steps at B=4, S=64 with a checkpoint, which must load
     bit for bit into a state made from another seed and give the same
     loss on a fixed batch, bit for bit. No training phase may launch a
     kernel: no kernel has a backward;
 20. dry-run: repro_torch.launch.dryrun in a subprocess (the fake process
     group it simulates the 256-device mesh on is process-global) for
     qwen2-vl-2b x decode_32k, chatglm3-6b x prefill_32k,
     phi3.5-moe-42b-a6.6b x decode_32k, jamba-1.5-large-398b x decode_32k,
     xlstm-125m x prefill_32k and whisper-base x train_4k on the single
     mesh; each record's per-device argument bytes, collectives and
     roofline terms are printed, every record key must be there, each
     serving pair's collectives must be the ones its layers issue,
     counted a layer (``dryrun_expected``: the tests of
     tests/test_torch_dryrun*.py pin the same arithmetic on reduced
     configs), the train pair's the record torch 2.13 gives
     (``DRYRUN_TRAIN_EXPECTED``), and JAX must not be loaded;
 21. launches per model, a JSON line of every kernel's numbers (launches
     summed over every serve, fleet and parity phase), then the device
     JSON line last.

Each serve phase of 12-16 prints TTFT per class, tokens/s, peak device
memory, its launches, and the host enqueue, enqueue-plus-device and
device (profiler) time of a decode step (and, on the paged path, of a
512-token prefill step).

``--profile`` adds a profiler table of one full-width qwen2-vl-2b train
step, and, after each serve phase, where a serving step's time goes: a
decode step's (qwen2-vl) or decode forward's (gemma3) host enqueue
against enqueue-plus-device time with a profiler table, the same
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
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
if not (SRC / "repro_torch").is_dir():
    print(f"FAIL: the port's sources are not beside this script ({SRC})",
          file=sys.stderr)
    sys.exit(1)
sys.path.insert(0, str(SRC))
# H100 SXM device memory bytes/s and dense bf16 tensor-core FLOP/s, from
# the port's roofline model
from repro_torch.launch.analysis import (  # noqa: E402
    HBM_BW as HBM_BYTES_PER_S, PEAK_FLOPS as BF16_FLOPS_PER_S)

H, KV, HD, PAGE = 12, 2, 128, 16          # qwen2-vl-2b
GH, GKV, GMAX, GWIN = 32, 16, 2048, 1024   # gemma3-27b, max_len, window
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

def _pool(torch, gen, n_pages, kv=KV, hd=HD):
    kp = torch.randn((n_pages, PAGE, kv, hd), generator=gen, device="cuda")
    vp = torch.randn((n_pages, PAGE, kv, hd), generator=gen, device="cuda")
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


def check_decode(torch, mod, gen, lengths, flush, label,
                 shape=(H, KV, HD), softcap=0.0):
    B = len(lengths)
    maxp = 4096 // PAGE
    n_pages = B * maxp + 64
    h, kv, hd = shape
    kp, vp = _pool(torch, gen, n_pages, kv, hd)
    bt = _tables(torch, gen, B, maxp, n_pages)
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = torch.randn((B, h, hd), generator=gen, device="cuda").to(
        torch.bfloat16)
    cap = dict(softcap=softcap)
    out = mod.paged_attention(q, kp, vp, bt, ln, **cap)
    torch.cuda.synchronize()
    ref = mod.plain(q.float(), kp.float(), vp.float(), bt, ln, **cap)
    zero_rows = [i for i, n in enumerate(lengths) if n == 0]
    if zero_rows and out[zero_rows].abs().max().item() != 0.0:
        fail("decode: length-0 rows are not exact zeros")
    err, rel = compare(out, ref, f"decode {label}")
    T = maxp * PAGE
    k_ctx = kp[bt.long()].reshape(B, T, kv, hd).transpose(1, 2)
    v_ctx = vp[bt.long()].reshape(B, T, kv, hd).transpose(1, 2)
    mask = (torch.arange(T, device="cuda")[None, :] <
            ln.long()[:, None])[:, None, None, :]
    qs = q[:, :, None, :]
    ms = time_ms(torch, lambda: mod.paged_attention(q, kp, vp, bt, ln, **cap),
                 flush=flush)
    plain_ms = time_ms(torch, lambda: mod.plain(q, kp, vp, bt, ln, **cap),
                       reps=5)
    lib_ms = None      # SDPA has no softcap: no library call for it
    if not softcap:
        lib_ms = time_ms(torch, lambda: _gqa_sdpa(torch, qs, k_ctx, v_ctx,
                                                  mask), flush=flush)
    live = sum(lengths)
    bytes_ = (live * kv * hd * 2 * 2 + 2 * q.numel() * 2 + bt.numel() * 4
              + B * 4)
    flops = 4 * live * h * hd
    n, chunk = mod.split_plan(B, kv, maxp * PAGE, PAGE)
    return _row(err, rel, ms, plain_ms, lib_ms, bytes_, flops,
                f"decode {label}, H={h} KV={kv} hd={hd} softcap={softcap}, "
                f"B={B} contexts<= {max(lengths)} "
                f"[split: n_split={n} chunk={chunk} blocks={B * kv * n}]")


def check_prefill(torch, mod, gen, q_start, new_lens, Sq, flush,
                  shape=(H, KV, HD), softcap=0.0):
    from repro_torch.kernels import tiles
    B = len(q_start)
    maxp = 4096 // PAGE
    n_pages = B * maxp + 64
    h, kv, hd = shape
    kp, vp = _pool(torch, gen, n_pages, kv, hd)
    bt = _tables(torch, gen, B, maxp, n_pages)
    qs_t = torch.tensor(q_start, dtype=torch.int32, device="cuda")
    nl_t = torch.tensor(new_lens, dtype=torch.int32, device="cuda")
    q = torch.randn((B, Sq, h, hd), generator=gen, device="cuda").to(
        torch.bfloat16)
    cap = dict(softcap=softcap)
    out = mod.paged_prefill_attention(q, kp, vp, bt, qs_t, nl_t, **cap)
    torch.cuda.synchronize()
    ref = mod.plain(q.float(), kp.float(), vp.float(), bt, qs_t, nl_t, **cap)
    pad = torch.arange(Sq, device="cuda")[None, :] >= nl_t.long()[:, None]
    if pad.any() and out[pad].abs().max().item() != 0.0:
        fail("prefill: padding queries are not exact zeros")
    err, rel = compare(out, ref, f"prefill H={h} KV={kv} softcap={softcap}")
    T = maxp * PAGE
    k_ctx = kp[bt.long()].reshape(B, T, kv, hd).transpose(1, 2)
    v_ctx = vp[bt.long()].reshape(B, T, kv, hd).transpose(1, 2)
    qpos = qs_t.long()[:, None] + torch.arange(Sq, device="cuda")[None, :]
    kpos = torch.arange(T, device="cuda")[None, None, :]
    total = (qs_t + nl_t).long()[:, None, None]
    mask = ((kpos <= qpos[:, :, None]) & (kpos < total))[:, None]
    qt = q.transpose(1, 2)
    ms = time_ms(torch, lambda: mod.paged_prefill_attention(
        q, kp, vp, bt, qs_t, nl_t, **cap), flush=flush)
    plain_ms = time_ms(torch, lambda: mod.plain(q, kp, vp, bt, qs_t, nl_t,
                                                **cap), reps=5)
    lib_ms = None      # SDPA has no softcap: no library call for it
    if not softcap:
        lib_ms = time_ms(torch, lambda: _gqa_sdpa(torch, qt, k_ctx, v_ctx,
                                                  mask), flush=flush)
    live = sum(s + n for s, n in zip(q_start, new_lens))
    pairs = sum((s + i + 1) for s, n in zip(q_start, new_lens)
                for i in range(n))
    bytes_ = (live * kv * hd * 2 * 2 + 2 * q.numel() * 2 + bt.numel() * 4
              + 2 * B * 4)
    flops = 4 * pairs * h * hd
    G = h // kv
    bq, n_tiles = tiles.plan(Sq, G)
    walks = []
    for s, n in zip(q_start, new_lens):
        for t in range(n_tiles):
            last = min((t + 1) * bq, n) - 1     # last real query of the tile
            if last >= t * bq:
                walks.append((min(bq, Sq - t * bq) * G, s + last + 1))
    blk = block_bound_ms(walks, hd)
    host = host_us(torch, lambda: mod.paged_prefill_attention(
        q, kp, vp, bt, qs_t, nl_t, **cap))
    row = _row(err, rel, ms, plain_ms, lib_ms, bytes_, flops,
               f"prefill H={h} KV={kv} hd={hd} softcap={softcap}, "
               f"B={B} Sq={Sq} q_start={q_start} "
               f"new_lens={new_lens} [tiles: BQ={bq} x {n_tiles}, "
               f"{n_tiles * B * kv} blocks]")
    print(f"  heaviest block's bound {blk:.4f} ms (one SM's share of the "
          f"peak); wrapper host time {host:.1f} us a call", flush=True)
    return row


def four_kernel_rows(torch, dec, pre, gen, flush):
    """Both paged kernels at the published head groups of the four
    decoders of phase 15 (``FOUR``) and qwen2-vl's serving lengths: G=16
    at KV=2, an odd G=7 (BQ=18: 126 of 128 rows, both chunks end
    mid-tile), G=8, and G=6 with grok-1's softcap 30."""
    from repro_torch.configs import get_config
    for arch, _, _ in FOUR:
        cfg = get_config(arch)
        shape = (cfg.num_heads, cfg.num_kv_heads, cfg.hd)
        check_decode(torch, dec, gen, DECODE_LENGTHS, flush,
                     f"B=16 mixed, {arch}", shape=shape,
                     softcap=cfg.logit_softcap)
        check_prefill(torch, pre, gen, [0, 1024, 3584, 0],
                      [512, 300, 512, 0], 512, flush, shape=shape,
                      softcap=cfg.logit_softcap)


SM_COUNT = 132                 # H100 SXM streaming multiprocessors


def block_bound_ms(walks, hd=HD):
    """The least time of the heaviest block of a prefill kernel: its
    bf16 operations (rows x keys walked x 4 hd, both products) over one
    SM's share of the card's peak. ``walks`` lists (rows, keys) per block.
    A kernel that never splits a block's keys cannot go below it."""
    rows, keys = max(walks, key=lambda w: w[0] * w[1])
    return 4 * rows * keys * hd / (BF16_FLOPS_PER_S / SM_COUNT) * 1e3


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


def dense_work(B, Sq, n_keys, q_start, window, shape=(GH, GKV, HD)):
    """(bytes, flops) the dense attention needs at ``shape`` (H, KV, hd;
    gemma3's widths by default) for B
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
    h, kv, hd = shape
    bytes_ = 2 * Sq * h * hd * 2 + 2 * keys * kv * hd * 2
    return B * bytes_, B * 4 * pairs * h * hd


def check_dense(torch, mod, gen, B, Sq, n_keys, q_start, window, softcap,
                flush, label, shape=(GH, GKV, HD)):
    """prefill_attention at ``shape`` (H, KV, hd; gemma3's by default): q
    (B, Sq, H, hd); K/V the first n_keys rows of a (B, 2048, KV, hd) slot
    buffer (a separate (B, Sq, KV, hd) pair for the cache-less case,
    n_keys == Sq)."""
    h, kv, hd = shape
    from repro_torch.kernels import tiles
    S = max(n_keys, GMAX) if n_keys != Sq else n_keys
    q = torch.randn((B, Sq, h, hd), generator=gen, device="cuda").to(
        torch.bfloat16)
    kb = torch.randn((B, S, kv, hd), generator=gen, device="cuda").to(
        torch.bfloat16)
    vb = torch.randn((B, S, kv, hd), generator=gen, device="cuda").to(
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
    bytes_, flops = dense_work(B, Sq, n_keys, q_start, window, shape)
    host = host_us(torch, lambda: mod.prefill_attention(q, k, v, **kw))
    blk = None
    if mod.decode_route(q, k, v):
        lo, hi = mod.key_range(n_keys, Sq, q_start, window)
        n, chunk = mod.split_plan(B, kv, lo, hi)
        route = (f"decode route, split: keys [{lo}, {hi}) n_split={n} "
                 f"chunk={chunk} blocks={B * kv * n}")
    else:
        bq, n_tiles = tiles.plan(Sq, h // kv)
        route = (f"chunk route, tiles: BQ={bq} x {n_tiles}, "
                 f"{n_tiles * B * kv} blocks")
        walks = []
        for t in range(n_tiles):
            q0, q1 = t * bq, min(Sq, (t + 1) * bq)
            lo, hi = mod.key_range(n_keys, q1 - q0, q_start + q0, window)
            walks.append(((q1 - q0) * (h // kv), hi - lo))
        blk = block_bound_ms(walks, hd)
    row = _row(err, rel, ms, plain_ms, lib_ms, bytes_, flops,
               f"prefill_attention {label}: H={h} KV={kv} hd={hd} B={B} "
               f"Sq={Sq} n_keys={n_keys} "
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
    return executor, counts, classifier, engine_cfg


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


def model_check(torch, executor, label, depth=2):
    """The served full-width weights of a one-stage paged model, cut to
    their first ``depth`` layers, on a small input (a 96-token prefill
    chunk, then one decode step, B=2) through the paged cache.

    Gate: inside that forward, every paged attention call (each layer,
    both steps) runs the kernel and its plain version on the same inputs
    (``CheckedOps``); their outputs must agree within rms 1e-2 and max
    5e-2 of the plain output's rms and max. Reported, not gated: the
    logits of the forward with attention through the kernels against the
    forward through their plain versions. With these random weights the
    attention logits are large (std ~100), so softmax rows are nearly
    one-hot and a row whose top two keys nearly tie picks another key on
    a last-bit difference; the two free-running forwards can then part
    whatever the kernels' accuracy."""
    from repro_torch.cache.paged import PagedStackStore
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg, layers = paged_layers(executor, depth)
    B, C, ppl = 2, 96, 16        # 2 rows x 7 pages, trash page 15
    gen = torch.Generator(device="cpu").manual_seed(7)
    toks = torch.randint(1, cfg.vocab_size, (B, C + 1), generator=gen)
    bt = torch.tensor([[i * 7 + j for j in range(7)] for i in range(B)],
                      dtype=torch.int32, device="cuda")
    checked = CheckedOps()
    outs = {}
    kernel_ops = L.kops
    for name, ops in (("kernel", kernel_ops), ("plain", PlainOps),
                      ("checked", checked)):
        stores = [{"b0": PagedStackStore.build(
            depth, ppl, PAGE, cfg.num_kv_heads, cfg.hd, device="cuda")}]
        logits = []
        L.kops = ops
        try:
            for start, n in ((0, C), (C, 1)):
                new_lens = torch.full((B,), n, dtype=torch.int32,
                                      device="cuda")
                cache = {"stages": stores, "block_table": bt,
                         "lengths": torch.full((B,), start,
                                               dtype=torch.int32,
                                               device="cuda"),
                         "new_lens": new_lens}
                pos = (start + torch.arange(n, device="cuda"))[None].expand(
                    B, n)
                with torch.no_grad():
                    lg, _, aux = T.forward(
                        executor.params, cfg,
                        toks[:, start:start + n].cuda(), positions=pos,
                        cache=cache, attn_impl="kernel",
                        last_pos=new_lens - 1, layers=layers)
                logits.append(lg.float())
        finally:
            L.kops = kernel_ops
        outs[name] = torch.cat(logits, dim=1)
    if not all(torch.isfinite(o).all() for o in outs.values()):
        fail(f"{label} model check: non-finite logits")
    a, b = outs["kernel"], outs["plain"]
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    moe = f"; MoE aux loss {aux.item():.4f}" if cfg.num_experts else ""
    print(f"{label} model check (full width, first {depth} layers, prefill "
          f"{C} + decode 1, B={B}, paged): {len(checked.calls)} attention "
          f"calls checked; free-running forwards, kernels vs plain: logits "
          f"{tuple(a.shape)}, max|diff| {(a - b).abs().max().item():.4f} of "
          f"max|logit| {b.abs().max().item():.4f}, argmax agreement "
          f"{agree:.2f}{moe}", flush=True)
    checked.gate(f"{label} model check", 2 * depth)


# ---------------------------------------------------------------------------
# phases 7-8: the fleet tier over replicas of the served qwen2-vl-2b
# ---------------------------------------------------------------------------

FLEET_REPLICAS = 3
MIGRATION_MAX_STEPS = (200, 2000)   # to RUNNING on the source; to the end
# the 16-request fleet run takes ~1200 co-sim steps (one engine step
# each); the bound stops the reference engine's two-request livelock
# within a minute or two
FLEET_MAX_STEPS = 6_000


def replica(executor):
    """A replica of the served model: its weights (params and fused layers)
    shared, its own paged stores, allocator and per-request state."""
    from repro_torch.serving.executors import ModelExecutor
    return ModelExecutor(executor.cfg, executor.config,
                         device=executor.device, params=executor.params,
                         layers=executor.layers)


class PayloadSpy:
    """Counts and times a replica's page-payload exports and imports (each
    ends in a host copy, so the wall time is the transfer's), and keeps
    what was imported: (pages, blobs) per call."""

    def __init__(self, executors):
        self.seconds = {"export": 0.0, "import": 0.0}
        self.bytes = {"export": 0, "import": 0}
        self.imports = []
        for ex in executors:
            ex.export_page_payload = self._wrap(ex.export_page_payload,
                                                "export")
            ex.import_page_payload = self._wrap(ex.import_page_payload,
                                                "import")

    def _wrap(self, fn, kind):
        def call(pages, *payloads):
            t = time.perf_counter()
            out = fn(pages, *payloads)
            self.seconds[kind] += time.perf_counter() - t
            blobs = out if kind == "export" else payloads[0]
            self.bytes[kind] += sum(len(b) for b in blobs)
            if kind == "import":
                self.imports.append((list(pages), list(blobs)))
            return out
        return call

    def line(self) -> str:
        return (f"payload exported {self.bytes['export']} bytes in "
                f"{self.seconds['export']:.4f}s, imported "
                f"{self.bytes['import']} bytes in "
                f"{self.seconds['import']:.4f}s")


def step_log(executor):
    """Record every engine iteration's call shape on ``executor``: the
    prefill rows (rid, tokens already prefilled, chunk) and the decode
    rids."""
    log = []
    run = executor.run_iteration

    def logged(prefill_work, decode_reqs, encode_work):
        log.append((tuple((r.rid, r.prefilled, c) for r, c in prefill_work),
                    tuple(r.rid for r in decode_reqs)))
        return run(prefill_work, decode_reqs, encode_work)
    executor.run_iteration = logged
    return log


def keep_prefill_logits(executor):
    """Keep, for each prefill forward (more than one token) of the
    executor, the logits of row 0's last position: after a request's last
    prefill chunk, the logits its first token was drawn from. Returns the
    list they are appended to. A replayed CUDA graph runs no Python, so
    the executor runs its forwards eagerly while they are kept."""
    kept = []
    T = executor.T
    executor._capture = None

    class Keeping:
        def __getattr__(self, name):
            return getattr(T, name)

        @staticmethod
        def forward(params, cfg, tokens, **kw):
            out = T.forward(params, cfg, tokens, **kw)
            if tokens.shape[1] > 1:
                kept.append(out[0][0, -1].float().clone())
            return out
    executor.T = Keeping()
    return kept


def rid_steps(log, rid, as_rid=None):
    """The iterations of ``log`` that ran ``rid`` (renamed ``as_rid``)."""
    out = []
    for prefill, decode in log:
        p = tuple((as_rid or r, s, c) for r, s, c in prefill if r == rid)
        d = sum(r == rid for r in decode)
        if p or d:
            out.append((p, d))
    return out


def run_until(engine, req, pred, max_steps, what):
    pending = [req]
    for _ in range(max_steps):
        pending = engine.step(pending)
        if pred():
            return
    fail(f"{what}: not done after {max_steps} engine steps (state "
         f"{req.state.value})")


def fleet_video(rid):
    """tests/test_fleet.py's video: 784 mm units (49 full shareable pages
    of 16) and a 32-token private text tail, 64 output tokens; every
    request of the phase carries the same video."""
    from repro_torch.serving.request import Modality, Request
    return Request(rid=rid, modality=Modality.VIDEO, arrival=0.0,
                   text_tokens=32, mm_units=784, prompt_tokens=816,
                   output_tokens=64, mm_hash="fleet-video")


def fleet_migration_phase(torch, executor, classifier, engine_cfg):
    """The full-width counterpart of benchmarks/fleet_tolerance.py's
    real-migration parity: three replicas of the served model (oracle,
    source, target). The video prefills on the source until it decodes,
    ``migrate`` ships its 49-page chain with the payload bytes, and the
    target finishes it.

    Gates: status ``migrated`` and 49 pages imported; the target's pages
    export the bytes the source sent; the request finished; no used page
    left on source or target; both paged kernels launched on the target;
    the tokens, and the logits of the first, equal, bit for bit, those of
    an oracle run on the same step shapes: the oracle prefilled the same
    video twice alone (so its chain is published, written in the source's
    chunks), then the same rid claims the same 784 tokens and prefills
    the same 32-token residual. Reported only: how many tokens an
    unmigrated oracle that prefills the whole prompt shares with the
    migrated run, how far its first-token logits are from the migrated
    run's and from its own admission-time whole-prompt prefill's (other
    call shapes round otherwise, and with these random weights a
    rounding difference can move the logits by their own size).
    Returns the phase's kernel launches."""
    from repro_torch.core.scheduler import make_policy
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.migration import MigrationConfig, migrate
    from repro_torch.serving.request import State

    def engine(ex):
        return Engine(make_policy("tcm"), ex, classifier, engine_cfg)

    ops.reset_launch_counts()
    ex_o, ex_s, ex_d = (replica(executor) for _ in range(FLEET_REPLICAS))
    logs = {name: step_log(ex) for name, ex in
            (("oracle", ex_o), ("source", ex_s), ("target", ex_d))}
    first = {name: keep_prefill_logits(ex)
             for name, ex in (("oracle", ex_o), ("target", ex_d))}
    spy = PayloadSpy([ex_s, ex_d])
    n_steps, n_end = MIGRATION_MAX_STEPS
    rid = "fleet-mig"

    # the unmigrated, unclaimed oracle: the whole prompt on one replica
    plain_req = fleet_video(rid)
    run_until(engine(ex_o), plain_req, lambda: plain_req.is_terminal, n_end,
              "fleet migration, unclaimed oracle")
    plain_tokens = list(ex_o.emitted[rid])
    # its admission-time isolated run (one whole-prompt prefill) and its
    # engine prefill's last chunk: the same prompt at other shapes
    iso_logits, plain_logits = first["oracle"][0], first["oracle"][-1]
    first["oracle"].clear()
    ex_o.evict_request(rid)

    # the source: prefill until it decodes, then migrate
    src, dst = engine(ex_s), engine(ex_d)
    req = fleet_video(rid)
    run_until(src, req, lambda: req.state is State.RUNNING, n_steps,
              "fleet migration, source prefill")
    prefilled = req.prefilled
    t0 = time.perf_counter()
    res = migrate(src, dst, req, src.now, MigrationConfig())
    t_mig = time.perf_counter() - t0
    print(f"fleet migration: prefilled {prefilled} of {req.prompt_tokens} "
          f"on the source, status {res.status}, {res.pages_imported} pages "
          f"imported ({res.pages_deduped} deduped), {res.chunks_sent} chunks "
          f"in {t_mig:.4f}s; {spy.line()}", flush=True)
    if res.status != "migrated" or res.pages_imported != 49:
        fail(f"fleet migration: status {res.status}, "
             f"{res.pages_imported} pages imported (want migrated, 49)")
    (pages, blobs), = spy.imports
    sent = [r.payload for r in res.delivered]
    if blobs != sent or ex_d.export_page_payload(pages) != sent:
        fail("fleet migration: the target's pages do not hold the bytes "
             "the source sent")
    print(f"fleet migration: {len(pages)} pages of {len(sent[0])} bytes "
          f"each byte-identical on the target", flush=True)
    before = ops.launch_counts()
    run_until(dst, req, lambda: req.is_terminal, n_end,
              "fleet migration, target")
    after = ops.launch_counts()
    moved = {k: after[k] - before[k] for k in after}
    tokens = list(ex_d.emitted.get(rid, []))
    if req.state is not State.FINISHED or len(tokens) != req.output_tokens:
        fail(f"fleet migration: {req.state.value} with {len(tokens)} tokens")
    if ex_d.export_page_payload(pages) != sent:
        fail("fleet migration: the imported pages changed while serving")
    used = (src.allocator.used_pages, dst.allocator.used_pages)
    if used != (0, 0):
        fail(f"fleet migration: used pages left (source, target) {used}")
    for a in (src.allocator, dst.allocator):
        a.check_invariants()
    for name in ("paged_attention", "paged_prefill_attention"):
        if moved[name] <= 0:
            fail(f"fleet migration: {name} never launched on the target")

    # the gated oracle: the same video twice alone (its chain published,
    # written in the source's chunks), then the same rid claims it
    eng_o = engine(ex_o)
    start = len(logs["oracle"])
    for i in range(2):
        carrier = fleet_video(f"fleet-carrier{i}")
        run_until(eng_o, carrier, lambda: carrier.is_terminal, n_end,
                  "fleet migration, oracle carrier")
    oracle_req = fleet_video(rid)
    run_until(eng_o, oracle_req, lambda: oracle_req.is_terminal, n_end,
              "fleet migration, oracle")
    oracle_tokens = list(ex_o.emitted[rid])
    shapes = {
        "source": rid_steps(logs["source"], rid, "r"),
        "carrier": rid_steps(logs["oracle"][start:], "fleet-carrier1", "r"),
        "target": rid_steps(logs["target"], rid),
        "oracle": rid_steps(logs["oracle"][start:], rid)}
    prefill_shapes = {k: [p for p, _d in v if p] for k, v in shapes.items()}
    print(f"fleet migration: prefill chunks (rid, start, tokens): source "
          f"{prefill_shapes['source']}, oracle's carrier "
          f"{prefill_shapes['carrier']}; target "
          f"{prefill_shapes['target']}, oracle {prefill_shapes['oracle']}; "
          f"claimed {req.cached_prefix_tokens} (target) and "
          f"{oracle_req.cached_prefix_tokens} (oracle)", flush=True)
    if prefill_shapes["source"] != prefill_shapes["carrier"] or \
            shapes["target"] != shapes["oracle"] or \
            req.cached_prefix_tokens != oracle_req.cached_prefix_tokens:
        fail("fleet migration: the oracle did not take the migrated run's "
             "step shapes")
    counts = ops.launch_counts()
    same = sum(a == b for a, b in zip(plain_tokens, tokens))
    part = next((i for i, (a, b) in enumerate(zip(plain_tokens, tokens))
                 if a != b), None)
    # the logits of the first token: the 32-token residual's last position
    # (target, shape-matched oracle) and the whole prompt's (unclaimed)
    lg, lo = first["target"][-1], first["oracle"][-1]
    top2 = plain_logits.topk(2).values

    def dmax(a, b):
        return (a - b).abs().max().item()
    print(f"fleet migration: {len(tokens)} tokens, identical to the "
          f"shape-matched oracle: {tokens == oracle_tokens}, first-token "
          f"logits bit-identical: {torch.equal(lg, lo)}; the unclaimed "
          f"oracle (whole prompt) matches {same} of {len(tokens)} (first "
          f"parting at {part}; its first-token logits differ from the "
          f"migrated run's by max {dmax(lg, plain_logits):.4f} of max|logit| "
          f"{plain_logits.abs().max().item():.4f}, top-2 gap "
          f"{(top2[0] - top2[1]).item():.4f}; from its own admission-time "
          f"whole-prompt prefill's by max {dmax(iso_logits, plain_logits):.4f}"
          f"); target launches {moved}; phase launches {counts}", flush=True)
    if tokens != oracle_tokens or not torch.equal(lg, lo):
        i = next((i for i, (a, b) in enumerate(zip(tokens, oracle_tokens))
                  if a != b), None)
        fail(f"fleet migration: the migrated run parts from the "
             f"shape-matched oracle (first token logits equal: "
             f"{torch.equal(lg, lo)}; tokens part at {i})")
    if "jax" in sys.modules:
        fail("fleet migration: jax was imported")
    return counts


def fleet_audit(fleet, reqs) -> dict:
    """benchmarks/fleet_tolerance.py's conservation audit: every engine
    that ever served (current, drained, killed and retired), allocator
    invariants, leaked pages and encoder pins, and the workload's terminal
    partition."""
    from repro_torch.serving.metrics import lifecycle_counts
    engines = list(fleet.engines) + [e for _i, e in fleet.retired]
    violations = leaked_pages = leaked_pins = 0
    for eng in engines:
        try:
            eng.allocator.check_invariants()
        except AssertionError:
            violations += 1
        leaked_pages += eng.allocator.used_pages
        if eng.encoder_cache is not None:
            leaked_pins += eng.encoder_cache.stats()["pin_refs"]
    counts = lifecycle_counts(reqs)
    finished, terminal = [], []
    for eng in engines:
        finished += [r.rid for r in eng.finished]
        terminal += [r.rid for r in eng.finished + eng.rejected + eng.aborted]
    return {
        "invariant_violations": violations,
        "leaked_pages": leaked_pages,
        "leaked_pins": leaked_pins,
        "in_flight": counts["in_flight"],
        "lost": (len(reqs) - sum(r.is_terminal for r in reqs)
                 + len(fleet.lost)),
        "double_finished": (len(finished) - len(set(finished))
                            + len(terminal) - len(set(terminal))),
    }


def drain_when_prefilled(Fleet):
    """``Fleet`` whose drain of replica ``drain_replica`` is set during the
    run: from the arrival of request ``drain_from`` on, at the first
    co-sim tick that finds the replica prefilling a request whose move
    would ship fresh pages (``_would_migrate``), the drain is scheduled
    at the arrival of the latest request by then (so it starts in that
    tick). Real-mode clocks are measured, so which tick that is varies
    between runs; the drain then always migrates a prefilled page chain."""
    from types import SimpleNamespace

    from repro_torch.serving.migration import build_manifest, \
        simulate_transfer

    @dataclasses.dataclass
    class DrainWhenPrefilled(Fleet):
        drain_replica: int = 0
        drain_from: int = 0
        arrivals: tuple = ()
        drain_request: int | None = None

        def _would_migrate(self, req, start) -> bool:
            """Whether moving ``req`` off the drained replica at ``start``
            lands a fresh page whichever eligible peer the drain picks:
            each lacks one of its prefilled chain pages and lives until
            the transfer ends (the fault plan's kill time aborts a
            migration to that replica, even once it has restarted)."""
            i = self.drain_replica
            pool = [j for j in self._eligible() if j != i]
            # the chain as the migration snapshots it, without payloads
            manifest = build_manifest(SimpleNamespace(
                allocator=self.engines[i].allocator, executor=None), req)
            chain = len(manifest) * self.engines[i].config.page_size
            limit = max(req.prompt_tokens - 1, 0)
            kill = self.faults.kill_time if self.faults else lambda _r: None
            return bool(pool) and all(
                self.engines[j].allocator.match_prefix(
                    req.content_chunks(), limit).tokens < chain and
                simulate_transfer(manifest, req.rid, start,
                                  self.fleet.migration, None, kill(i),
                                  kill(j)).status == "migrated"
                for j in pool)

        def _fleet_tick(self, pending, remaining):
            # restarts first, as the fleet's tick takes them (a second
            # call in the same tick changes nothing), so the test sees
            # the peers the drain will move requests to
            if self._restarts_armed():
                self._tick_restarts(pending, remaining,
                                    self._live_clock(remaining))
            i = self.drain_replica
            clk = self._live_clock(remaining)
            if self.drain_request is None and i in self._eligible() and \
                    clk is not None and \
                    clk >= self.arrivals[self.drain_from]:
                k = max(j for j, t in enumerate(self.arrivals) if t <= clk)
                start = max(self.engines[i].now, self.arrivals[k])
                if any(self._would_migrate(r, start)
                       for r in self.engines[i].prefilling):
                    self.drain_request = k
                    self.fleet.drains[i] = self.arrivals[k]
            return super()._fleet_tick(pending, remaining)
    return DrainWhenPrefilled


def fleet_serve_phase(torch, executor, classifier, engine_cfg,
                      n_requests=16, drain_from=6, kill_at=10):
    """A ``Fleet`` of three replicas of the served model, least-loaded
    routing, policy tcm, on 16 MH requests at 4 req/s (seed 0) with
    duplicates and shared prefixes (as benchmarks/fleet_tolerance.py
    shapes its traffic): replica 0 drains from the arrival of request 6
    (at the first tick its move would land fresh pages on a peer that
    outlives the transfer: ``drain_when_prefilled``),
    replica 2 is killed at the arrival of request 10 and restarts 1 s
    after, warmed from a peer's prefix trie over the page-chain protocol.

    Gates: the audit (``fleet_audit``) all zero, every request finished
    within the step bound, the drain, kill and restart happened, a
    migration imported payload pages and the warm import shipped payload.
    Returns the phase's kernel launches."""
    from repro_torch.kernels import ops
    from repro_torch.serving.faults import FaultPlan
    from repro_torch.serving.fleet import Fleet, FleetConfig
    from repro_torch.serving.metrics import fmt_table, summarize
    from repro_torch.serving.request import State
    from repro_torch.serving.workload import WorkloadConfig, generate

    reqs = generate(WorkloadConfig(mix="MH", rate=4.0,
                                   num_requests=n_requests, seed=0,
                                   duplicate_prob=0.3,
                                   shared_prefix_prob=0.3))
    kill_t = reqs[kill_at].arrival
    exes = [replica(executor) for _ in range(FLEET_REPLICAS)]
    spy = PayloadSpy(exes)
    fleet = drain_when_prefilled(Fleet)(
        exes, classifier, engine_cfg, policy="tcm", routing="least-loaded",
        faults=FaultPlan(replica_kills={2: kill_t}),
        fleet=FleetConfig(restarts={2: 1.0}, restart_warm_pages=256),
        drain_from=drain_from, arrivals=tuple(r.arrival for r in reqs))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = fleet.run_stepped(reqs, max_steps=FLEET_MAX_STEPS)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    audit = fleet_audit(fleet, reqs)
    warm = sum(e["warm_pages_imported"] for e in fleet.restart_events)
    mig_pages = fleet.migrated_pages - warm
    n_tok = sum(r.decoded for r in done)
    placed = {r.rid: i for i, eng in list(enumerate(fleet.engines)) +
              fleet.retired for r in eng.finished}
    print(fmt_table(summarize(done), f"fleet of {FLEET_REPLICAS} "
                    f"qwen2-vl-2b replicas | tcm | MH | {n_requests} "
                    f"requests"))
    k = fleet.drain_request
    drain = (f"drain of replica 0 at request {k}'s arrival "
             f"({reqs[k].arrival:.3f}s)" if k is not None else "no drain")
    iters = sum(e.iterations for e in list(fleet.engines) +
                [e for _i, e in fleet.retired])
    print(f"fleet serve: {drain}, kill of replica 2 at request {kill_at}'s "
          f"({kill_t:.3f}s); {len(done)}/{n_requests} finished, {iters} "
          f"engine iterations, "
          f"{n_tok} tokens in {t_run:.2f}s wall = {n_tok / t_run:.1f} "
          f"tokens/s; peak device memory {peak / 2**30:.2f} GiB (the "
          f"served model and its replicas); migrations attempted "
          f"{fleet.migrations_attempted}, "
          f"succeeded {fleet.migrations_succeeded}, fallbacks "
          f"{fleet.migration_fallbacks}, no-ops {fleet.migration_noops}; "
          f"pages moved by migration {mig_pages}, by warm import {warm}, "
          f"deduped {fleet.deduped_pages}; {spy.line()}; finished on "
          f"{placed}; drains {fleet.drain_events}; kills "
          f"{fleet.kill_events}; restarts {fleet.restart_events}; launches "
          f"{counts}; audit {audit}", flush=True)
    bad = {key: v for key, v in audit.items() if v}
    if bad:
        fail(f"fleet serve: audit {bad}")
    unfinished = [r.rid for r in reqs if r.state is not State.FINISHED]
    if unfinished:
        fail(f"fleet serve: not finished within {FLEET_MAX_STEPS} steps: "
             f"{unfinished}")
    if not (fleet.drain_events and fleet.kill_events and
            fleet.restart_events):
        fail("fleet serve: the drain, the kill or the restart did not happen")
    if mig_pages <= 0:
        fail("fleet serve: the drain migrated no payload pages")
    if warm <= 0:
        fail("fleet serve: the restart's warm import moved no payload")
    for name in ("paged_attention", "paged_prefill_attention"):
        if counts[name] <= 0:
            fail(f"fleet serve: kernel {name} never launched")
    if "jax" in sys.modules:
        fail("fleet serve: jax was imported")
    return counts


PARITY_ARCH = "chatglm3-6b"
PARITY_REQUESTS = 10
PARITY_KV_PAGES = 24
# A parting of two runs' greedy streams is a rounding tie when, at its
# first parted step, each run's pick beats the other run's pick by at most
# TIE_ULPS bf16 spacings (the spacing at the pick's logit). The logits are
# bf16, each the rounding of an f32 sum (within half a spacing), and two
# runs' sums differ by the rounding of reductions taken in another order
# upstream (other batch and call shapes pick other GEMM tilings on the
# card); the phase prints that drift, the largest difference of one logit
# between the runs, at the steps where they agree. Run A picks a over b
# and run B b over a only if gap_A + gap_B = (l_A[a] - l_B[a]) +
# (l_B[b] - l_A[b]) <= 2 D, D the largest difference of one logit; D of
# at most 2 spacings (one of rounding, one of drift) bounds each gap by 4.
TIE_ULPS = 4


def parity_mix():
    """The duplicate- and shared-prefix-heavy mini mix of
    benchmarks/prefix_cache.py's ``measure_real_parity``."""
    from repro_torch.serving.workload import WorkloadConfig
    return WorkloadConfig(mix="ML", rate=50.0, num_requests=PARITY_REQUESTS,
                          seed=7, out_tokens_log_mu=1.8,
                          out_tokens_log_sigma=0.3, text_tokens_log_mu=3.2,
                          text_tokens_log_sigma=0.5, video_frames_min=1,
                          video_frames_max=2, image_patches=32,
                          video_patches_per_frame=16, duplicate_prob=0.6,
                          shared_prefix_prob=0.6,
                          shared_prefix_tokens_min=20,
                          shared_prefix_tokens_max=40)


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 numbers (8 significant bits) at ``|x|``."""
    return math.ldexp(1.0, math.frexp(max(abs(x), 2.0 ** -126))[1] - 8)


class EmittedLogits:
    """Keeps, for each (rid, token index) ``executor`` emits, the logits
    row (bf16, on the device) of the forward that drew the token. A
    forward's rows are named as the executor lays them out: the batched
    path's packed calls (prefill waves and decodes alike) carry their
    rids, and the dense-slot path acquires a request's slot right before
    its forward. A later forward for the same
    index (a re-prefill after a preemption) replaces the row. A replayed
    CUDA graph runs no Python, so the executor runs its forwards eagerly
    while it is kept."""

    def __init__(self, executor):
        self.rows = {}
        self.rids = []
        ex, T, keep = executor, executor.T, self
        ex._capture = None

        class Keeping:
            def __getattr__(self, name):
                return getattr(T, name)

            @staticmethod
            def forward(*args, **kw):
                out = T.forward(*args, **kw)
                last = out[0][:, -1]
                for j, rid in enumerate(keep.rids):
                    at = len(ex.emitted.get(rid, ()))
                    keep.rows[(rid, at)] = last[j].clone()
                return out
        ex.T = Keeping()
        if ex.legacy:
            acquire = ex.acquire_slot

            def acquiring(req):
                self.rids = [req.rid]
                return acquire(req)
            ex.acquire_slot = acquiring
            return
        call = ex._paged_call

        def calling(rows):
            self.rids = [r[0] for r in rows]
            try:
                return call(rows)
            finally:
                self.rids = []
        ex._paged_call = calling


def parity_run(torch, executor, classifier, engine_cfg, cache: bool,
               keep_logits: bool = True):
    """The mix through ``Engine.step`` on ``executor``, the prefix cache
    on or off, with one recompute-style preemption forced on the first
    running request (as ``measure_real_parity`` does), for at most
    ``SERVE_MAX_ITERS`` steps. Gates: every request finished, the
    allocator's invariants, a token stream for each request, a preemption,
    and with the cache on a prefix hit. Returns the run's streams, logits
    records (``keep_logits``, which runs the forwards eagerly; else none,
    and the batched path replays its CUDA graphs), prefix stats, launches
    and seconds."""
    from repro_torch.core.scheduler import make_policy
    from repro_torch.device import synchronize
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.workload import generate

    label = (f"legacy parity, {executor.attn_impl}, "
             + ("real-legacy" if executor.legacy else
                f"cache {'on' if cache else 'off'}")
             + ("" if keep_logits else ", graphs"))
    keep = EmittedLogits(executor) if keep_logits else None
    eng = Engine(make_policy("tcm"), executor, classifier,
                 dataclasses.replace(engine_cfg, prefix_cache=cache))
    ops.reset_launch_counts()
    pending = generate(parity_mix())
    forced = False
    t0 = time.perf_counter()
    for _ in range(SERVE_MAX_ITERS):
        pending = eng.step(pending)
        if not forced and eng.running:
            eng._preempt(next(iter(eng.running)))   # mid-decode evict
            forced = True
        if len(eng.finished) + len(eng.rejected) == PARITY_REQUESTS:
            break
    else:
        fail(f"{label}: stopped at SERVE_MAX_ITERS = {SERVE_MAX_ITERS} "
             f"engine steps with {len(eng.finished)} of {PARITY_REQUESTS} "
             "finished")
    synchronize(executor.device)
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    stats = eng.allocator.prefix_stats()
    emitted = {r.rid: list(executor.emitted.get(r.rid) or ())
               for r in eng.finished}
    preempts = sum(r.preemptions for r in eng.finished)
    print(f"{label}: {len(eng.finished)}/{PARITY_REQUESTS} finished, "
          f"{eng.iterations} iterations, {preempts} preemptions, prefix "
          f"hits {stats['hits']}, COW copies {stats['cow_copies']}, "
          f"evictions {stats['evictions']}, {secs:.2f}s; launches "
          f"{counts}", flush=True)
    if len(eng.finished) != PARITY_REQUESTS:
        fail(f"{label}: {len(eng.finished)} of {PARITY_REQUESTS} finished "
             f"({len(eng.rejected)} rejected)")
    eng.allocator.check_invariants()
    empty = [rid for rid, toks in emitted.items() if not toks]
    if empty:
        fail(f"{label}: requests with no tokens: {empty}")
    if preempts < 1:
        fail(f"{label}: no preemption")
    if cache and not executor.legacy and stats["hits"] < 1:
        fail(f"{label}: no prefix hit")
    return dict(emitted=emitted, logits=keep.rows if keep else {},
                hits=stats["hits"],
                cow=stats["cow_copies"], counts=counts, secs=secs)


def parity_compare(runs):
    """Compare the runs' streams ("on", "off", "legacy"): for each request
    whose streams part, each pair of runs that parts, at its first parted
    step, where a parting is a tie only as ``TIE_ULPS`` says; and each
    pair's largest logit drift at the steps where it agrees. Returns
    (parted streams, tied streams, lines to print)."""
    lines, parted, tied = [], 0, 0
    drift = {}
    for rid in sorted(runs["legacy"]["emitted"]):
        streams = {key: run["emitted"].get(rid)
                   for key, run in runs.items()}
        all_tie = True
        for a, b in (("on", "legacy"), ("off", "legacy"), ("on", "off")):
            sa, sb = streams[a], streams[b]
            at = next((i for i, (x, y) in enumerate(zip(sa, sb)) if x != y),
                      min(len(sa), len(sb)))
            for i in range(at):
                la = runs[a]["logits"].get((rid, i))
                lb = runs[b]["logits"].get((rid, i))
                if la is not None and lb is not None:
                    d = float((la.float() - lb.float()).abs().max())
                    ulps = d / bf16_ulp(float(la.float().max()))
                    drift[(a, b)] = max(drift.get((a, b), (0.0, 0.0)),
                                        (ulps, d))
            if sa == sb:
                continue
            la = runs[a]["logits"].get((rid, at))
            lb = runs[b]["logits"].get((rid, at))
            if at >= min(len(sa), len(sb)) or la is None or lb is None:
                all_tie = False
                lines.append(f"parting, not a tie: {rid} {a} vs {b} at "
                             f"token {at} (lengths {len(sa)}, {len(sb)}; "
                             f"logits kept {la is not None}, "
                             f"{lb is not None})")
                continue
            ta, tb = sa[at], sb[at]
            la, lb = la.float(), lb.float()
            gaps = [(float(la[ta] - la[tb]), bf16_ulp(float(la[ta]))),
                    (float(lb[tb] - lb[ta]), bf16_ulp(float(lb[tb])))]
            top2 = [float(x[0] - x[1]) for x in (la.topk(2).values,
                                                 lb.topk(2).values)]
            tie = all(g <= TIE_ULPS * u for g, u in gaps)
            all_tie = all_tie and tie
            lines.append(
                f"{'tie' if tie else 'parting, not a tie'}: {rid} {a} vs "
                f"{b} at token {at}: {ta} vs {tb}, logits {a} "
                f"{float(la[ta])} / {float(la[tb])}, {b} {float(lb[ta])} / "
                f"{float(lb[tb])}; each pick's lead "
                + ", ".join(f"{g:.6g} ({g / u:.2f} spacings)"
                            for g, u in gaps)
                + f" (bound {TIE_ULPS}); top-two gaps {top2[0]:.6g}, "
                f"{top2[1]:.6g}")
        if any(streams[k] != streams["legacy"] for k in streams):
            parted += 1
            tied += all_tie
    lines += [f"largest logit drift at agreeing steps, {a} vs {b}: "
              f"{u:.2f} spacings ({d:.6g})"
              for (a, b), (u, d) in sorted(drift.items())]
    return parted, tied, lines


def legacy_parity_phase(torch):
    """Full-width chatglm3-6b (28 layers, bf16) through ``build_stack``
    with a 24-page pool, its q/k/v then scaled to fan-in D
    (``fused_qkv_fan_in_d``: at the declared fan-in every softmax row is
    one-hot, and two right bf16 evaluations part wherever a rounding picks
    another key), then ``measure_real_parity``'s scenario three ways (the
    batched executor with the prefix cache on and off, and the
    ``real-legacy`` dense-slot oracle; replicas sharing the built weights)
    on both attention routes. "gather": the gather path and ``mha`` on
    both sides, no kernel; its streams must agree up to printed rounding
    ties (``TIE_ULPS``). "kernel": both paged kernels on the batched side,
    ``prefill_attention`` on the dense side; its partings are printed,
    not gated, since the reference promises no parity across attention
    numerics. On each route the batched cache-on run goes once more with
    its CUDA graphs (the runs above keep logits, so they run eagerly):
    the same gates, and the streams equal to the eager run's are printed
    (the engine's clock is the measured step time, so the two runs need
    not plan the same batches). Returns the phase's kernel launches."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_stack
    from repro_torch.serving.executors import ModelExecutor

    t0 = time.perf_counter()
    base, classifier, engine_cfg, profile, _ = build_stack(
        PARITY_ARCH, "real", full=True, kv_pages=PARITY_KV_PAGES,
        device="cuda")
    cfg = base.cfg
    if cfg != get_config(PARITY_ARCH):
        fail("legacy parity: not the full-width chatglm3-6b")
    fused_qkv_fan_in_d(base.layers, cfg)
    print(f"model {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, H={cfg.num_heads}, KV={cfg.num_kv_heads}, "
          f"dtype {cfg.dtype}; KV pool {base.capacity_pages} pages, "
          f"max_len {base.max_len}, {base.max_slots} slots; stack built "
          f"({len(profile.records)} profiled requests) in "
          f"{time.perf_counter() - t0:.2f}s; q/k/v scaled to fan-in D",
          flush=True)
    total = {}
    summary = []
    for route in ("gather", "kernel"):
        t1 = time.perf_counter()
        runs = {}
        for key, legacy, cache in (("on", False, True),
                                   ("off", False, False),
                                   ("legacy", True, True)):
            ex = ModelExecutor(
                cfg, dataclasses.replace(base.config, legacy=legacy,
                                         attn_impl=route),
                device=base.device, params=base.params, layers=base.layers)
            runs[key] = run = parity_run(torch, ex, classifier, engine_cfg,
                                         cache)
            c = run["counts"]
            label = f"legacy parity, {route}, {key}"
            if route == "gather":
                need(label, c, idle=tuple(c))
            elif legacy:
                need(label, c, launched=("prefill_attention",),
                     idle=("paged_attention", "paged_prefill_attention"))
            else:
                need(label, c, launched=("paged_attention",
                                         "paged_prefill_attention"),
                     idle=("prefill_attention",))
            for name, n in c.items():
                total[name] = total.get(name, 0) + n
        ex = ModelExecutor(
            cfg, dataclasses.replace(base.config, attn_impl=route),
            device=base.device, params=base.params, layers=base.layers)
        before = obs.snapshot()["counters"]
        graphs = parity_run(torch, ex, classifier, engine_cfg, True,
                            keep_logits=False)
        after = obs.snapshot()["counters"]
        n = {k: after.get(f"exec.graph_{k}", 0) - before.get(
            f"exec.graph_{k}", 0) for k in ("captures", "replays", "eager")}
        same = sum(graphs["emitted"][rid] == toks
                   for rid, toks in runs["on"]["emitted"].items())
        print(f"legacy parity, {route}, graphs: {same} of "
              f"{len(runs['on']['emitted'])} streams equal to the eager "
              f"cache-on run's; graph captures {n['captures']}, replays "
              f"{n['replays']}, eager calls {n['eager']}", flush=True)
        if n["replays"] <= 0:
            fail(f"legacy parity, {route}, graphs: no graph replayed")
        c = graphs["counts"]
        if route == "gather":
            need(f"legacy parity, {route}, graphs", c, idle=tuple(c))
        else:
            need(f"legacy parity, {route}, graphs", c,
                 launched=("paged_attention", "paged_prefill_attention"),
                 idle=("prefill_attention",))
        for name, k in c.items():
            total[name] = total.get(name, 0) + k
        parted, tied, lines = parity_compare(runs)
        print("\n".join(f"legacy parity, {route}: {line}"
                        for line in lines), flush=True)
        summary.append(
            f"{route}: parted streams {parted} of {PARITY_REQUESTS}, ties "
            f"{tied}, prefix hits {runs['on']['hits']}, COW copies "
            f"{runs['on']['cow']}, {time.perf_counter() - t1:.2f}s")
        if route == "gather" and parted != tied:
            fail(f"legacy parity, gather: {parted - tied} streams part "
                 "other than at a rounding tie")
    print(f"legacy parity: {'; '.join(summary)}", flush=True)
    if "jax" in sys.modules:
        fail("legacy parity: jax was imported")
    return total


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
    """``kernels.ops`` for a check inside the forward: each attention call
    runs the kernel and its plain version on the same inputs, records how
    far apart they are (q's shape, the window, rms and max of the
    difference relative to the plain output's), and returns the plain
    output, so every layer of the check sees the same inputs."""

    def __init__(self):
        self.calls = []

    def _check(self, mod, fn, q, *args, **kw):
        a = fn(q, *args, **kw).float()
        b = mod.plain(q, *args, **kw)
        d, bf = (a - b.float()), b.float()
        self.calls.append((tuple(q.shape), kw.get("window", 0),
                           (d.square().mean().sqrt()
                            / bf.square().mean().sqrt()).item(),
                           (d.abs().max() / bf.abs().max()).item()))
        return b

    def prefill_attention(self, q, k, v, **kw):
        from repro_torch.kernels import prefill_attention as mod
        return self._check(mod, mod.prefill_attention, q, k, v, **kw)

    def paged_attention(self, q, *args, **kw):
        from repro_torch.kernels import paged_attention as mod
        return self._check(mod, mod.paged_attention, q, *args, **kw)

    def paged_prefill_attention(self, q, *args, **kw):
        from repro_torch.kernels import paged_prefill_attention as mod
        return self._check(mod, mod.paged_prefill_attention, q, *args, **kw)

    def gate(self, label, expect):
        """Print every call; fail unless there were ``expect`` of them, each
        within rms 1e-2 and max 5e-2 of the plain output's rms and max."""
        for shape, window, rel_rms, rel_max in self.calls:
            print(f"  attention in the forward, q {shape}, window {window}: "
                  f"kernel vs plain rms {rel_rms:.2e}, max {rel_max:.2e} "
                  f"(relative to the plain output)")
        if len(self.calls) != expect:
            fail(f"{label}: {len(self.calls)} attention calls checked, "
                 f"expected {expect}")
        bad = [c for c in self.calls if not (c[2] <= 1e-2 and c[3] <= 5e-2)]
        if bad:
            fail(f"{label}: kernel and plain version part inside the "
                 f"forward: {bad}")


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
    a, b = outs["kernel"], outs["plain"]
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    print(f"gemma3 model check (full width, first {depth} layers "
          f"{cfg.pattern()}, prefill {prompt} + decode 1 through the dense "
          f"cache): {len(checked.calls)} prefill_attention calls checked; "
          f"free-running forwards, kernel vs plain: last-position logits "
          f"{tuple(a.shape)}, max|diff| {(a - b).abs().max().item():.4f} "
          f"of max|logit| {b.abs().max().item():.4f}, argmax agreement "
          f"{agree:.2f}", flush=True)
    checked.gate("gemma3 model check", 2 * depth)


# ---------------------------------------------------------------------------
# the other decoder families: phi3.5-moe and the four decoders of phase
# 15 (paged), jamba, whisper, xlstm (dense slots)
# ---------------------------------------------------------------------------

PHI = "phi3.5-moe-42b-a6.6b"
PHI_LAYERS = 24        # of 32: at full depth the bf16 weights (83.7 GB) fill
#                        the card; at 24 they are 62.9 GB
JAMBA = "jamba-1.5-large-398b"
JAMBA_LAYERS = 5       # of 72: the published pattern's first five layers
#                        (Mamba, Mamba+MoE, Mamba, Mamba+MoE, attention),
#                        48.1 GB in bf16; one 8-layer period is ~91 GB


# (arch, depth or None for all layers, kv_pages or None for the default)
# of the four decoders served on the batched paged path after the other
# families: bf16 weights 12.5 GB (chatglm3-6b), 66.7 GB (deepseek-coder-33b
# whole: the default 4096 pages, 16.6 GB of KV at 62 layers, do not fit
# beside them, 1024 pages hold four 4096-token windows in 4.2 GB), 59.3 GB
# (qwen1.5-110b at 20 of 80 layers: 2.72 GB a layer and 4.98 GB of
# embedding and head) and 62.3 GB (grok-1-314b at 6 of 64: 9.84 GB a
# layer), near phi3.5-moe's 62.9 GB
FOUR = (("chatglm3-6b", None, None), ("deepseek-coder-33b", None, 1024),
        ("qwen1.5-110b", 20, None), ("grok-1-314b", 6, None))
FOUR_REQUESTS = 8


def four_serve_phases(torch, launches):
    """The four decoders of the batched paged path (``FOUR``) at their
    published widths and head groups, each served, model-checked (and
    grok-1's ``moe_block`` checked), then freed; their launches go into
    ``launches`` under the arch's name."""
    from repro_torch.configs import get_config
    for arch, depth, kv_pages in FOUR:
        full = get_config(arch)
        cut = f"{depth or full.num_layers} of {full.num_layers}"
        phase(f"{arch} serve ({cut} layers)")
        cfg = dataclasses.replace(full, num_layers=depth) if depth else full
        ex, launches[arch] = family_serve_phase(
            torch, f"{arch} ({cut} layers)", cfg, FOUR_REQUESTS,
            max_len=4096, dense=False, kv_pages=kv_pages,
            check=lambda ex, c, a=arch: need(
                a, c, launched=("paged_attention", "paged_prefill_attention"),
                idle=("prefill_attention",)))
        phase(f"{arch} model check")
        model_check(torch, ex, arch)
        if cfg.num_experts:
            moe_block_check(torch, ex)
        del ex
        gc.collect()
        torch.cuda.empty_cache()


def step_times(torch, fn, reps=5):
    """(host enqueue, enqueue plus device, device) ms of one call of
    ``fn``: ``timed_steps`` over ``reps`` calls, and the device time from
    the profiler (the sum of the device's own kernel and copy times) over
    ``reps`` more, per call. ``fn`` must not synchronise."""
    from torch.profiler import ProfilerActivity, profile
    host, total = timed_steps(torch, fn, reps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    _, dev_us = device_share(prof, ())
    return host * 1e3, total * 1e3, dev_us / reps / 1e3


def print_step(label, times):
    host, total, dev = times
    print(f"  {label}: host enqueue {host:.2f} ms, enqueue+device "
          f"{total:.2f} ms, device {dev:.2f} ms "
          f"({'host' if host >= dev else 'device'}-bound)", flush=True)


def paged_step_times(torch, executor, B=8, ctx=1000, chunk=512):
    """Host and device time of a B-row decode step at context ``ctx`` and
    of a ``chunk``-token prefill step at context ``ctx``, through the
    forward the executor's ``_step`` runs (inputs already on the card)."""
    T, cfg, alloc = executor.T, executor.cfg, executor.allocator
    page = alloc.page_size
    rids = [f"__step_{i}" for i in range(B)]
    for rid in rids:
        alloc.allocate(rid, ctx + chunk + 8)
    try:
        def make(rows, n):
            bt = executor._block_table_rows(
                rows, executor._bucket_pages(-(-(ctx + n) // page)))
            gen = np.random.default_rng(5)
            args = dict(
                tokens=gen.integers(1, cfg.vocab_size, (len(rows), n)),
                positions=np.tile(ctx + np.arange(n), (len(rows), 1)),
                block_table=bt, lengths=np.full(len(rows), ctx),
                new_lens=np.full(len(rows), n))
            t = {k: torch.from_numpy(np.asarray(v, np.int32)).cuda()
                 for k, v in args.items()}
            cache = {"stages": executor.stores,
                     "block_table": t["block_table"],
                     "lengths": t["lengths"], "new_lens": t["new_lens"]}

            def step():
                with torch.no_grad():
                    lg, _, _ = T.forward(
                        executor.params, cfg, t["tokens"],
                        positions=t["positions"], cache=cache,
                        last_pos=t["new_lens"] - 1,
                        attn_impl=executor.attn_impl, layers=executor.layers)
                    return torch.argmax(lg[:, 0], dim=-1)
            return step
        print_step(f"decode step B={B} at context {ctx}",
                   step_times(torch, make(rids, 1)))
        print_step(f"prefill step, one {chunk}-token chunk at context {ctx}",
                   step_times(torch, make(rids[:1], chunk), reps=3))
    finally:
        for rid in rids:
            alloc.free(rid)


def slot_step_times(torch, executor, ctx=1000):
    """Host and device time of one request's decode forward at context
    ``ctx`` over a dense slot cache (the dense-slot path's decode step),
    then the slot zeroed. (A prefill chunk's time shows in TTFT; xLSTM's
    takes seconds of host, a Python step per token, and its profile
    would take minutes.)"""
    from repro_torch.models.params import tree_leaves
    cache = executor.caches[0]
    tok = torch.ones((1, 1), dtype=torch.int64, device="cuda")

    def step():
        cache["idx"].fill_(ctx)
        with torch.no_grad():
            return executor._legacy_forward(tok, None, cache, ctx)[0]
    print_step(f"decode forward at context {ctx}", step_times(torch, step))
    for leaf in tree_leaves(cache, torch.is_tensor):
        leaf.zero_()


class PlanSpy:
    """Counts the split plans (``kernels/split.py``) the paged decode
    kernel takes and the tile plans (``kernels/tiles.py``) the paged
    prefill kernel takes while it is installed: each distinct plan with
    its inputs and how many calls took it."""

    def __init__(self):
        from repro_torch.kernels import paged_attention as dec
        from repro_torch.kernels import tiles
        self.split, self.tiles = {}, {}
        self._saved = [(dec, "split_plan", dec.split_plan),
                       (tiles, "plan", tiles.plan)]
        for (mod, name, fn), seen in zip(self._saved,
                                         (self.split, self.tiles)):
            setattr(mod, name, self._spy(fn, seen))

    @staticmethod
    def _spy(fn, seen):
        def spied(*args):
            out = fn(*args)
            seen[args, out] = seen.get((args, out), 0) + 1
            return out
        return spied

    def close(self):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)

    def lines(self):
        return [f"  {what} plans taken, {args}: calls: " + "; ".join(
                    f"{a} -> {o}: {n}" for (a, o), n in
                    sorted(seen.items(), key=lambda kv: -kv[1]))
                for what, args, seen in (
                    ("decode split", "(B, KV, table keys, page) -> "
                     "(n_split, chunk)", self.split),
                    ("prefill tile", "(Sq, G) -> (BQ, n_tiles)",
                     self.tiles))]


# a serve phase's bound on engine iterations: its runs take a few hundred;
# the reference engine can livelock (ROADMAP §3), and a phase must then
# fail rather than hang
SERVE_MAX_ITERS = 10_000


def family_serve_phase(torch, label, model_cfg, n_requests, *, max_len,
                       dense, check, kv_pages=None):
    """Serve ``model_cfg`` through ``build_stack``'s real mode (warm-up,
    profiler, estimator, classifier), then the engine on MH requests at 2
    req/s, seed 0, for at most ``SERVE_MAX_ITERS`` iterations. ``dense``:
    the dense-slot path, with 4 slots, ``max_num_seqs`` 3 and KV pages only
    accounting (sized so that no prompt is rejected), as the gemma3 phase
    runs it; else the batched paged path at the default KV capacity, or
    at ``kv_pages`` pages with ``max_num_seqs`` the number of
    ``max_len`` windows they hold (so that the running requests' windows
    always fit), printing the split and tile plans the paged kernels took.
    ``check(executor, counts)`` fails the phase on the model's own
    conditions (kernels launched, path taken). Returns (executor,
    launches)."""
    from repro_torch.core.scheduler import make_policy
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_stack
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.metrics import fmt_table, summarize
    from repro_torch.serving.request import State
    from repro_torch.serving.workload import WorkloadConfig, generate

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    kw = dict(max_slots=4, kv_pages=4096) if dense else \
        dict(kv_pages=kv_pages)
    executor, classifier, engine_cfg, profile, _ = build_stack(
        model_cfg, "real", max_len=max_len, device="cuda", **kw)
    t_build = time.perf_counter() - t0
    cfg = executor.cfg
    print(f"model {cfg.name}: {cfg.num_layers} layers "
          f"{sorted(set(cfg.pattern()))}, d_model {cfg.d_model}, "
          f"H={cfg.num_heads}, KV={cfg.num_kv_heads}, hd={cfg.hd}, experts "
          f"{cfg.num_experts} top-{cfg.experts_per_token}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}, dtype {cfg.dtype}; "
          f"legacy={executor.legacy}, max_len {executor.max_len}; stack "
          f"built (weights, warm-up, {len(profile.records)} profiled "
          f"requests, estimator, classifier) in {t_build:.2f}s; device "
          f"memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB, peak "
          f"while building {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB", flush=True)
    torch.cuda.reset_peak_memory_stats()
    if executor.legacy != dense:
        fail(f"{label} serve: legacy={executor.legacy}, expected {dense}")
    if dense:
        engine_cfg = dataclasses.replace(
            engine_cfg, max_num_seqs=executor.max_slots - 1)
    elif kv_pages is not None:
        engine_cfg = dataclasses.replace(
            engine_cfg, max_num_seqs=kv_pages * PAGE // max_len)
    print(f"KV pool {executor.capacity_pages} pages of {PAGE} tokens, "
          f"max_num_seqs {engine_cfg.max_num_seqs}", flush=True)
    reqs = generate(WorkloadConfig(mix="MH", rate=2.0,
                                   num_requests=n_requests, seed=0))
    engine = Engine(make_policy("tcm"), executor, classifier, engine_cfg)
    spy = None if dense else PlanSpy()
    t1 = time.perf_counter()
    try:
        done = engine.run(reqs, max_iters=SERVE_MAX_ITERS)
        torch.cuda.synchronize()
    finally:
        if spy is not None:
            spy.close()
    t_run = time.perf_counter() - t1
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = {r.rid: len(executor.emitted.get(r.rid, [])) for r in reqs}
    summary = summarize(done)
    print(fmt_table(summary, f"{label} | tcm | MH | {n_requests} requests"))
    n_tok = sum(tokens.values())
    print(f"{label} serve: {len(done)}/{len(reqs)} finished, "
          f"{engine.iterations} iterations, {n_tok} tokens in "
          f"{t_run:.2f}s wall = {n_tok / t_run:.1f} tokens/s; launches "
          f"{counts}; peak device memory while serving {peak / 2**30:.2f} "
          f"GiB ({peak} bytes); prompt tokens "
          f"{sorted(r.prompt_tokens for r in reqs)}", flush=True)
    unfinished = [r.rid for r in reqs if r.state is not State.FINISHED]
    if unfinished:
        fail(f"{label} serve: requests not finished: {unfinished}")
    empty = [rid for rid, n in tokens.items() if n == 0]
    if empty:
        fail(f"{label} serve: requests with no tokens: {empty}")
    if "jax" in sys.modules:
        fail(f"{label} serve: jax was imported")
    check(executor, counts)
    if spy is not None:
        print("\n".join(spy.lines()), flush=True)
    if dense:
        slot_step_times(torch, executor)
    else:
        paged_step_times(torch, executor)
    return executor, counts


def need(label, counts, launched=(), idle=()):
    """A ``check`` for ``family_serve_phase``: each kernel in ``launched``
    launched at least once in the phase, none in ``idle``."""
    for name in launched:
        if counts[name] <= 0:
            fail(f"{label} serve: kernel {name} never launched")
    for name in idle:
        if counts[name] != 0:
            fail(f"{label} serve: kernel {name} launched")


def paged_layers(executor, depth):
    """The served layers of a one-stage model cut to its first ``depth``,
    with the config to match."""
    full = executor.cfg
    if full.stages() != [((full.pattern()[0],), full.num_layers)]:
        fail("model check: expected one stacked stage")
    return (dataclasses.replace(full, num_layers=depth),
            [{"b0": executor.layers[0]["b0"][:depth]}])


def per_token_rel(out, ref):
    """Per token (last axis: features) rms of ``out - ref`` over the rms of
    ``ref``, for tokens whose ``ref`` is not all zero; and the overall
    relative rms."""
    d = (out.float() - ref.float())
    rr = ref.float().square().mean(-1).sqrt()
    live = rr > 0
    tok = d.square().mean(-1).sqrt()[live] / rr[live]
    return tok, (d.square().mean().sqrt() / ref.float().square().mean()
                 .sqrt()).item()


def moe_block_check(torch, executor, S=512):
    """Layer 0's expert weights of the served MoE model (phi3.5-moe: 16
    experts, d_ff 6400; grok-1: 8 experts, d_ff 32768; bf16 on the card):
    ``moe_block`` over a 512-token chunk on the card against the same
    function in f32 on the CPU on the same values (copied to the host in
    bf16 and widened there: grok-1's layer is 19.3 GB in f32, which the
    host must hold). The routing (f32 router logits on both) must be
    identical; each token's output within 2e-2 of its rms."""
    from repro_torch.models import layers as L
    cfg = executor.cfg
    p = executor.layers[0]["b0"][0]["moe"]
    f32_bytes = 4 * sum(v.numel() for v in p.values())
    avail = host_available_bytes()
    print(f"moe_block check: layer 0's weights {f32_bytes / 1e9:.2f} GB in "
          f"f32 on the host, which has {avail / 1e9:.2f} GB available",
          flush=True)
    if avail < 1.25 * f32_bytes:
        fail("moe_block check: the host cannot hold the f32 reference")
    gen = torch.Generator(device="cpu").manual_seed(13)
    x = torch.randn((1, S, cfg.d_model), generator=gen).to(torch.bfloat16)
    xc = x.cuda()
    with torch.no_grad():
        route = L.moe_route(xc, p["router"], cfg)
        y, aux = L.moe_block(xc, p, cfg)
        torch.cuda.synchronize()
        p32 = {k: v.cpu().float() for k, v in p.items()}
        ref_route = L.moe_route(x.float(), p32["router"], cfg)
        ref, ref_aux = L.moe_block(x.float(), p32, cfg)
    drops = int((~route["keep"]).sum())
    gone = int((~route["keep"]).all(-1).sum())
    same = bool(torch.equal(route["topi"].cpu(), ref_route["topi"])
                and torch.equal(route["keep"].cpu(), ref_route["keep"]))
    tok, rel = per_token_rel(y.cpu(), ref)
    times = step_times(torch, lambda: L.moe_block(xc, p, cfg)[0], reps=5)
    print(f"moe_block check ({cfg.name} layer 0, {cfg.num_experts} experts "
          f"of d_ff {cfg.d_ff}, "
          f"top-{cfg.experts_per_token}, a {S}-token chunk: G={route['G']}, "
          f"C={route['C']} slots an expert): bf16 on the card vs f32 on the "
          f"CPU: routing identical {same}; {drops} of "
          f"{S * cfg.experts_per_token} (token, expert) choices dropped by "
          f"capacity, {gone} tokens dropped whole; per-token rms error max "
          f"{tok.max().item():.3e}, median {tok.median().item():.3e}, "
          f"overall {rel:.3e}; aux {aux.item():.4f} vs {ref_aux.item():.4f}"
          f"; the block on the card: device {times[2]:.3f} ms, host "
          f"enqueue {times[0]:.3f} ms", flush=True)
    if not same:
        fail("moe_block check: routing differs between card and CPU")
    if not (tok.max().item() <= 2e-2):
        fail(f"moe_block check: a token's output is {tok.max().item():.3e} "
             "of its rms away from the f32 reference")


def host_available_bytes() -> int:
    """The host's available memory (``MemAvailable``), in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    fail("moe_block check: /proc/meminfo has no MemAvailable")


def mamba_check(torch, executor, S=512, decodes=8):
    """Layer 0's Mamba weights of the served full-width jamba (d_model
    8192, DI 16384, N 16, conv 4): a 512-token prefill from a zero state,
    then 8 decode steps from the state it leaves, against the same
    function in f32 on the CPU on the same values. In f32 on the card
    each token's output within 1e-4 of its rms and the final SSM state
    within 1e-4: the card computes the function. In bf16 on the card (as
    served) no further from the f32 reference (each token's error
    relative to its rms at worst, overall, final state) than the same
    bf16 function on the CPU is, with 10% slack, and overall and state
    within 2e-2: bf16 rounding alone moves a token of small output by
    several % of its rms, on either device."""
    from repro_torch.models.ssm import mamba_block
    cfg = executor.cfg
    DI, N, KC = cfg.d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    if cfg.pattern()[0] != "mamba":
        fail("mamba_block check: layer 0 of the served model is not Mamba")
    p = executor.layers[0]["b0"][0]["mamba"]
    x = torch.randn((1, S + decodes, cfg.d_model),
                    generator=torch.Generator().manual_seed(3)).to(
                        torch.bfloat16)

    def run(dtype, device):
        params = {k: v.to(device=device, dtype=dtype) for k, v in p.items()}
        xs = x.to(device=device, dtype=dtype)
        state = {"conv": torch.zeros((1, KC - 1, DI), dtype=dtype,
                                     device=device),
                 "ssm": torch.zeros((1, DI, N), device=device)}
        ys = []
        for a, b in [(0, S)] + [(t, t + 1) for t in range(S, S + decodes)]:
            y, state = mamba_block(xs[:, a:b], params, cfg, cache=state)
            ys.append(y)
        return torch.cat(ys, dim=1).cpu(), state

    with torch.no_grad():
        ref, ref_st = run(torch.float32, "cpu")
        errs = {}
        for name, dtype, device in (("card bf16", torch.bfloat16, "cuda"),
                                    ("card f32", torch.float32, "cuda"),
                                    ("CPU bf16", torch.bfloat16, "cpu")):
            y, st = run(dtype, device)
            tok, rel = per_token_rel(y, ref)
            errs[name] = (tok.max().item(), rel,
                          ((st["ssm"].cpu() - ref_st["ssm"]).norm()
                           / ref_st["ssm"].norm()).item())
            if name == "card bf16":
                card_st = st
        xc = x[:, :S].cuda()
        zero = {"conv": torch.zeros((1, KC - 1, DI), dtype=torch.bfloat16,
                                    device="cuda"),
                "ssm": torch.zeros((1, DI, N), device="cuda")}
        pre = step_times(torch, lambda: mamba_block(xc, p, cfg,
                                                    cache=zero)[0], reps=3)
        x1 = x[:, S:S + 1].cuda()
        dec = step_times(torch, lambda: mamba_block(x1, p, cfg,
                                                    cache=card_st)[0])
    print(f"mamba_block check (jamba full width: d_model {cfg.d_model}, "
          f"DI {DI}, N {N}, conv {KC}; prefill {S} + {decodes} decodes, "
          f"against f32 on the CPU; a token's error relative to its rms at "
          f"worst, overall, final ssm state): " + "; ".join(
              f"{name} {e[0]:.3e}, {e[1]:.3e}, {e[2]:.3e}"
              for name, e in errs.items()), flush=True)
    print_step(f"mamba_block prefill of {S} tokens", pre)
    print_step("mamba_block decode step", dec)
    card, card32, base = (errs[k] for k in ("card bf16", "card f32",
                                            "CPU bf16"))
    if not (card32[0] <= 1e-4 and card32[2] <= 1e-4):
        fail("mamba_block check: the card's f32 block is not the function")
    if not (all(c <= 1.1 * b for c, b in zip(card, base))
            and card[1] <= 2e-2 and card[2] <= 2e-2):
        fail("mamba_block check: the card's bf16 block is further from the "
             "f32 reference than bf16 on the CPU is")


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


# ---------------------------------------------------------------------------
# training: one step on the card against the CPU, full-width qwen2-vl-2b,
# xlstm-125m through the launcher with a checkpoint
# ---------------------------------------------------------------------------

QWEN = "qwen2-vl-2b"
CHECK_LAYERS, CHECK_S, CHECK_LR = 2, 256, 3e-4  # the card against the CPU
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 1024, 5       # full-width qwen2-vl-2b
XLSTM_ARGS = ["--steps", "20", "--batch", "4", "--seq", "64"]
BF16_ULP = 2.0 ** -7


def image_batch(torch, cfg, B, S, step, dev):
    """``PackedTokenDataset`` batch ``step`` (B rows of S tokens) with a
    stub image: its first N = min(mm_tokens, S // 2) positions take random
    patch embeddings on a grid of r rows by N // r columns (M-RoPE
    positions: temporal 0, row, column), the text after it runs on from
    max(rows, columns) on all three streams, and the loss is masked where
    the label is an image token."""
    from repro_torch.train.data import PackedTokenDataset
    n = min(cfg.mm_tokens, S // 2)
    rows = max(r for r in range(1, math.isqrt(n) + 1) if n % r == 0)
    cols = n // rows
    b = PackedTokenDataset(cfg.vocab_size, S, seed=0).batch(step, B)
    g = np.random.default_rng(step)
    b["mm_embeds"] = g.standard_normal((B, n, cfg.d_model), np.float32)
    pos = np.zeros((S, 3), np.int32)
    pos[:n, 1], pos[:n, 2] = np.arange(n) // cols, np.arange(n) % cols
    pos[n:] = (max(rows, cols) + np.arange(S - n))[:, None]
    b["positions"] = np.broadcast_to(pos, (B, S, 3)).copy()
    b["loss_mask"] = np.ones((B, S), np.float32)
    b["loss_mask"][:, :n - 1] = 0.0
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def same_bits(torch, a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def grads_of(torch, state, metrics):
    """A first step's gradient leaves on the CPU, read back from its first
    moment: mu = (1 - b1) * g * min(1, 1 / |g|) from zero moments."""
    from repro_torch.train.optimizer import leaves
    scale = 0.1 * min(1.0, 1.0 / max(metrics["grad_norm"], 1e-9))
    return [m.cpu() / scale for m in leaves(state.opt.mu)]


def grad_errors(got, want):
    """(rms over the leaves of each leaf's relative rms error, the worst
    leaf's max error relative to its max)."""
    rms, worst = [], 0.0
    for g, w in zip(got, want, strict=True):
        d = (g - w).double()
        rms.append(float(d.square().mean().sqrt() /
                         w.double().square().mean().sqrt()))
        worst = max(worst, float(d.abs().max() / w.abs().max()))
    return math.sqrt(sum(r * r for r in rms) / len(rms)), worst


def qkv_fan_in_d(params, cfg):
    """Scale every attention q/k/v projection (a stacked ``(layers, D,
    heads, hd)`` leaf) in place to fan-in D, as the parity tests run them
    (tests/torch_parity.fan_in_d). Both packages draw them at fan-in
    ``heads`` (the declaration rule reads the second-to-last axis): at
    qwen2-vl-2b's widths attention logits then have std ~300, every
    softmax row is one-hot, two right bf16 evaluations part wherever a
    rounding picks another key, and the gradient grows by orders of
    magnitude a layer (``train_qwen_phase`` prints it at full depth)."""
    for stage in params["stages"]:
        for blk in stage.values():
            for name in ("wq", "wk", "wv"):
                w = blk["attn"][name]
                w.mul_(math.sqrt(w.shape[-2] / cfg.d_model))


def fused_qkv_fan_in_d(layers, cfg):
    """``qkv_fan_in_d`` on an executor's fused layers (its stacked q/k/v
    are released): each ``wqkv`` holds the q, k and v columns side by
    side (``layers.fuse_attn``)."""
    H, KV, hd, D = cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.d_model
    for stage in layers:
        for blk in stage.values():
            for lp in blk:
                lp["wqkv"][:, :H * hd].mul_(math.sqrt(H / D))
                lp["wqkv"][:, H * hd:].mul_(math.sqrt(KV / D))


def grad_norm(torch, params, cfg, batch):
    """(loss, global gradient norm) of ``loss_fn`` at ``params``, without
    an update."""
    from repro_torch.models.params import tree_map
    from repro_torch.train import loop
    from repro_torch.train.optimizer import leaves
    live = tree_map(lambda p: p.detach().requires_grad_(), params,
                    is_leaf=torch.is_tensor)
    total, (loss, _) = loop.loss_fn(live, cfg, batch)
    grads = torch.autograd.grad(total, leaves(live))
    norm = torch.sqrt(sum(g.to(torch.float32).square().sum() for g in grads))
    return float(loss.detach()), float(norm)


def train_check_phase(torch):
    """One ``train_step`` of full-width qwen2-vl-2b cut to CHECK_LAYERS
    (f32 masters from one seed, one image batch of CHECK_S tokens) on the
    card and on the CPU, in f32 and in the default bf16 compute, with the
    q/k/v projections at fan-in D (``qkv_fan_in_d``). f32: loss and grad
    norm within 1e-3 relative, each gradient leaf within 1e-3 of its max
    |g|, the updated parameters within 2 lr (Adam's first step moves each
    by lr times its gradient's sign). bf16: the card's gradients no
    further from the CPU's f32 ones than the CPU's bf16 are (the rms of
    the leaves' relative rms errors at most 1.1x, the worst leaf's max
    error at most 1.1x plus one bf16 ulp), its loss within 1e-3 relative
    of the f32 loss. A ``prefill_attention`` call on a query that
    requires grad must raise, and no kernel may launch. Returns the launch
    counts."""
    from repro_torch.configs import get_config
    from repro_torch.device import synchronize
    from repro_torch.kernels import ops
    from repro_torch.models.params import tree_map
    from repro_torch.train import loop
    from repro_torch.train.optimizer import adamw_init, leaves
    ops.reset_launch_counts()
    cfg = dataclasses.replace(get_config(QWEN), num_layers=CHECK_LAYERS)
    masters = loop.make_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(1), "cuda").params
    qkv_fan_in_d(masters, cfg)
    host = tree_map(lambda t: t.cpu(), masters, is_leaf=torch.is_tensor)
    batch = image_batch(torch, cfg, 1, CHECK_S, 0, "cpu")
    print(f"train check: {cfg.name} at full width cut to {CHECK_LAYERS} "
          f"layers ({sum(t.numel() for t in leaves(host))} parameters), "
          f"B=1, S={CHECK_S}, {int(batch['mm_embeds'].shape[1])} image "
          f"units", flush=True)
    runs = {}
    for where, dtype in (("card", torch.float32), ("cpu", torch.float32),
                         ("card", torch.bfloat16), ("cpu", torch.bfloat16)):
        dev = "cuda" if where == "card" else "cpu"
        params = tree_map(torch.clone, masters if where == "card" else host,
                          is_leaf=torch.is_tensor)
        b = {k: v.to(dev) for k, v in batch.items()}
        synchronize(dev)
        t0 = time.perf_counter()
        state, m = loop.train_step(
            loop.TrainState(params, adamw_init(params)), b,
            dataclasses.replace(cfg, dtype=dtype), base_lr=CHECK_LR)
        synchronize(dev)
        sec = time.perf_counter() - t0
        m = {k: float(v) for k, v in m.items()}
        key = f"{where} {str(dtype).replace('torch.', '')}"
        runs[key] = dict(m, grads=grads_of(torch, state, m), params=[
            t.cpu() for t in leaves(state.params)])
        print(f"  {key}: loss {m['loss']:.6f}, grad norm "
              f"{m['grad_norm']:.6f}, lr {m['lr']:.3e}, {sec:.2f} s",
              flush=True)
        if not all(math.isfinite(v) for v in m.values()):
            fail(f"train check {key}: metrics not finite: {m}")
        del state, params
    card, cpu = runs["card float32"], runs["cpu float32"]
    diff = {k: abs(card[k] - cpu[k]) for k in ("loss", "grad_norm")}
    worst = max(float((g - w).abs().max() / w.abs().max())
                for g, w in zip(card["grads"], cpu["grads"]))
    p_err = max(float((a - b).abs().max())
                for a, b in zip(card["params"], cpu["params"]))
    moved = sum(not torch.equal(a, b)
                for a, b in zip(cpu["params"], leaves(host)))
    lr = cpu["lr"]
    print(f"  f32, card vs CPU: loss {diff['loss']:.3e}, grad norm "
          f"{diff['grad_norm']:.3e}, worst gradient leaf {worst:.3e} of its "
          f"max |g| (limit 1e-3), parameters {p_err:.3e} (limit 2 lr = "
          f"{2 * lr:.3e}); {moved}/{len(cpu['params'])} leaves moved",
          flush=True)
    if any(diff[k] > 1e-3 * abs(cpu[k]) for k in diff):
        fail(f"train check f32: loss and grad norm part by {diff}")
    if worst > 1e-3:
        fail(f"train check f32: gradients part by {worst:.3e} of scale")
    if p_err > 2 * lr * (1 + 1e-3):
        fail(f"train check f32: parameters part by {p_err} > 2 lr")
    if moved != len(cpu["params"]):
        fail(f"train check: only {moved} leaves moved")
    on_card = grad_errors(runs["card bfloat16"]["grads"], cpu["grads"])
    on_cpu = grad_errors(runs["cpu bfloat16"]["grads"], cpu["grads"])
    dl = {k: abs(runs[k]["loss"] - cpu["loss"])
          for k in ("card bfloat16", "cpu bfloat16")}
    print(f"  bf16 against the CPU's f32: card rms {on_card[0]:.3e}, worst "
          f"leaf {on_card[1]:.3e}, loss {dl['card bfloat16']:.3e}; CPU "
          f"rms {on_cpu[0]:.3e}, worst leaf {on_cpu[1]:.3e}, loss "
          f"{dl['cpu bfloat16']:.3e}", flush=True)
    if on_card[0] > 1.1 * on_cpu[0] or \
            on_card[1] > 1.1 * on_cpu[1] + BF16_ULP:
        fail(f"train check bf16: the card's gradients ({on_card}) are "
             f"further from f32 than the CPU's bf16 ones ({on_cpu})")
    if dl["card bfloat16"] > 1e-3 * abs(cpu["loss"]):
        fail(f"train check bf16: the card's loss parts from f32 by "
             f"{dl['card bfloat16']}")
    q = torch.zeros((1, 4, cfg.num_heads, cfg.hd), dtype=torch.bfloat16,
                    device="cuda", requires_grad=True)
    k = torch.zeros((1, 4, cfg.num_kv_heads, cfg.hd), dtype=torch.bfloat16,
                    device="cuda")
    try:
        ops.prefill_attention(q, k, k)
    except RuntimeError as e:
        print(f"  prefill_attention under autograd raised: {e}")
    else:
        fail("train check: prefill_attention ran under autograd")
    counts = ops.launch_counts()
    need("train check", counts, idle=tuple(counts))
    return counts


def train_bound_ms(cfg, n_params, B, S):
    """The least time of one step: its products at the bf16 peak (6 flops
    a parameter a token outside the embedding lookup, and the attention's
    QK and PV products over every (query, key) pair, forward and
    backward), and AdamW's bytes at the memory rate (f32 parameters,
    gradients and both moments read, parameters and moments written)."""
    matmul = 6 * (n_params - cfg.vocab_size * cfg.d_model) * B * S
    attn = 3 * 4 * B * S * S * cfg.num_heads * cfg.hd * cfg.num_layers
    ops_ms = (matmul + attn) / BF16_FLOPS_PER_S * 1e3
    adam_ms = 7 * 4 * n_params / HBM_BYTES_PER_S * 1e3
    return ops_ms, adam_ms


GEMM_KERNELS = ("gemm", "nvjet", "xmma", "cutlass")


def train_profile(torch, state, cfg, batch):
    """A profiler table of one train step (kept: ``train_step`` writes
    the state in place), its device time, and the share of it in matrix
    products (kernels named like cuBLAS's)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train import loop
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = loop.train_step(state, batch, cfg)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=15))
    gemm, total = device_share(prof, GEMM_KERNELS)
    print(f"  profiled train step: device time {total / 1e3:.2f} ms, "
          f"matrix products {gemm / 1e3:.2f} ms ({gemm / max(total, 1e-9):.1%})",
          flush=True)
    return state


def train_qwen_phase(torch, profile=False):
    """TRAIN_STEPS train steps of full-width qwen2-vl-2b (f32 masters from
    a seed, the config's bf16 compute) over image batches of TRAIN_B rows
    of TRAIN_S tokens, then two with ``remat``
    (the first pays ``torch.utils.checkpoint``'s one-time set-up): each
    step's loss, grad norm, lr, synchronised seconds, tokens/s and peak
    device memory. First the gradient norm at the declared init is
    printed; the steps run with the q/k/v projections at fan-in D
    (``qkv_fan_in_d``). Then a forward and backward alone, timed, and
    with ``profile`` a profiler table of one more step. Gates: finite
    metrics, parameters that moved, no kernel launched. Returns the
    launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.device import synchronize
    from repro_torch.kernels import ops
    from repro_torch.train import loop
    from repro_torch.train.optimizer import leaves
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    cfg, B, S, steps, dev = get_config(QWEN), TRAIN_B, TRAIN_S, \
        TRAIN_STEPS, "cuda"
    t0 = time.perf_counter()
    state = loop.make_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    synchronize(dev)
    n = sum(t.numel() for t in leaves(state.params))
    before = [t.clone() for t in (state.params["final_norm"],
                                  state.params["stages"][0]["b0"]["mlp"]
                                  ["wo"][0])]
    ops_ms, adam_ms = train_bound_ms(cfg, n, B, S)
    print(f"train {cfg.name}: {cfg.num_layers} layers, {n} parameters "
          f"(f32 masters and moments: {16 * n / 1e9:.2f} GB with the "
          f"gradients), compute {cfg.dtype}, B={B}, S={S}; state made in "
          f"{time.perf_counter() - t0:.2f} s; bound {ops_ms:.2f} ms of "
          f"products at the bf16 peak + {adam_ms:.2f} ms of AdamW bytes",
          flush=True)
    loss, norm = grad_norm(torch, state.params, cfg,
                           image_batch(torch, cfg, B, S, 0, dev))
    print(f"  at the declared init (q/k/v at fan-in heads): loss "
          f"{loss:.4f}, gradient norm {norm:.4e}; the steps run with q/k/v "
          f"at fan-in D", flush=True)
    qkv_fan_in_d(state.params, cfg)
    secs = []
    for step in range(steps + 2):
        remat = step >= steps
        if step == steps:
            torch.cuda.reset_peak_memory_stats()
        batch = image_batch(torch, cfg, B, S, step, dev)
        synchronize(dev)
        t1 = time.perf_counter()
        state, m = loop.train_step(state, batch, cfg, remat=remat)
        synchronize(dev)
        sec = time.perf_counter() - t1
        m = {k: float(v) for k, v in m.items()}
        peak = torch.cuda.max_memory_allocated()
        print(f"  step {step}{' (remat)' if remat else ''}: loss "
              f"{m['loss']:.4f}, grad norm {m['grad_norm']:.4f}, lr "
              f"{m['lr']:.3e}, {sec:.4f} s, {B * S / sec:.1f} tokens/s, "
              f"peak device memory {peak / 2**30:.2f} GiB ({peak} bytes)",
              flush=True)
        if not all(math.isfinite(v) for v in m.values()):
            fail(f"train {cfg.name} step {step}: metrics not finite: {m}")
        if 0 < step < steps:
            secs.append(sec)
    if secs:
        mean = sum(secs) / len(secs)
        print(f"  steps 1-{steps - 1}: {mean:.4f} s/step, "
              f"{B * S / mean:.1f} tokens/s", flush=True)
    batch = image_batch(torch, cfg, B, S, steps + 2, dev)
    synchronize(dev)
    t1 = time.perf_counter()
    grad_norm(torch, state.params, cfg, batch)
    synchronize(dev)
    print(f"  forward and backward alone: {time.perf_counter() - t1:.4f} s",
          flush=True)
    if profile:
        state = train_profile(torch, state, cfg, batch)
    after = (state.params["final_norm"],
             state.params["stages"][0]["b0"]["mlp"]["wo"][0])
    if any(torch.equal(a, b) for a, b in zip(before, after)):
        fail(f"train {cfg.name}: parameters did not move")
    counts = ops.launch_counts()
    need(f"train {cfg.name}", counts, idle=tuple(counts))
    return counts


def train_xlstm_phase(torch):
    """The launcher (``repro_torch.launch.train.main``) with its default
    arch, xlstm-125m at full size, with XLSTM_ARGS and a checkpoint;
    then the checkpoint loaded into a state made from another seed: every
    leaf equal bit for bit to the trained state, and a forward loss on one
    fixed batch bit-identical. No kernel may launch. Returns the launch
    counts."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.device import synchronize
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launcher
    from repro_torch.train import loop
    from repro_torch.train.checkpoint import load
    from repro_torch.train.data import PackedTokenDataset
    from repro_torch.train.optimizer import leaves
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    steps, batch, seq = (int(a) for a in XLSTM_ARGS[1::2])
    dev = "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "xlstm_125m.npz")
        t0 = time.perf_counter()
        live = launcher.main(XLSTM_ARGS + ["--ckpt", ckpt])
        synchronize(dev)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        size = os.path.getsize(ckpt)
        cfg = dataclasses.replace(get_config("xlstm-125m"), max_seq_len=seq)
        other = loop.make_train_state(
            cfg, torch.Generator(device=dev).manual_seed(1), dev)
        t1 = time.perf_counter()
        restored = load(ckpt, other)
        synchronize(dev)
        t_load = time.perf_counter() - t1
    print(f"train xlstm-125m: {steps} steps in {wall:.2f} s "
          f"({wall / steps:.3f} s/step with the state's making and the "
          f"checkpoint), peak device memory {peak / 2**30:.2f} GiB ({peak} "
          f"bytes); checkpoint {size} bytes, loaded in {t_load:.2f} s",
          flush=True)
    differ = [i for i, (a, b) in enumerate(zip(leaves(restored),
                                               leaves(live), strict=True))
              if not same_bits(torch, a, b)]
    if differ:
        fail(f"train xlstm-125m: restored leaves {differ} differ")
    b = {k: torch.from_numpy(v).to(dev) for k, v in
         PackedTokenDataset(cfg.vocab_size, seq, seed=1).batch(0, batch)
         .items()}
    with torch.no_grad():
        l_live = loop.loss_fn(live.params, cfg, b)[0]
        l_back = loop.loss_fn(restored.params, cfg, b)[0]
    print(f"  {len(leaves(live))} leaves restored bit for bit; loss on a "
          f"fixed batch {float(l_live):.6f} live, {float(l_back):.6f} "
          f"restored", flush=True)
    if not same_bits(torch, l_live, l_back):
        fail("train xlstm-125m: the restored state's loss differs")
    counts = ops.launch_counts()
    need("train xlstm-125m", counts, idle=tuple(counts))
    return counts


DRYRUN_PAIRS = (("qwen2-vl-2b", "decode_32k"), ("chatglm3-6b", "prefill_32k"),
                ("phi3.5-moe-42b-a6.6b", "decode_32k"),
                ("jamba-1.5-large-398b", "decode_32k"),
                ("xlstm-125m", "prefill_32k"), ("whisper-base", "train_4k"))
# the train pairs' collectives, as torch 2.13 records them (a train step's
# count is not a layer's sum: the gathers of FSDP weights, the products'
# backward, the LayerNorms' gradients summed whole); the chip machine's
# torch must give the same (tests/test_torch_dryrun_families.py pins the
# reduced pair and this record)
DRYRUN_TRAIN_EXPECTED = {
    ("whisper-base", "train_4k"): {"all-gather": 258, "all-reduce": 82},
}
DRYRUN_KEYS = {"arch", "shape", "mesh", "devices", "mode", "opts", "params",
               "padded_heads", "orig_heads", "padded_kv", "orig_kv",
               "lower_s", "compile_s", "flops", "bytes_accessed", "memory",
               "collectives", "analytic", "roofline"}
DRYRUN_CODE = """
import json, sys
from repro_torch.launch.dryrun import run_one
pairs = json.loads(sys.argv[1])
records = [run_one(a, s, "single", "", write=False) for a, s in pairs]
print(json.dumps({"records": records, "jax_loaded": "jax" in sys.modules}))
"""


def dryrun_expected(cfg) -> dict:
    """The collectives a device issues in a serving forward on the single
    mesh, layer by layer: one all-reduce for the vocab-sharded embedding
    lookup; an attention block's output (one all-reduce); a Mamba block's
    dt/B/C products and output projection (two) and in_proj's halves
    moved onto the inner dim's shards (four collective-permutes); an
    mLSTM block's output (one), its q, k, v and two gates reduced onto
    each rank's heads (five reduce-scatters) and up_proj's halves (four
    permutes); an sLSTM block's output (one) and its heads gathered for
    the FFN (one all-gather); a dense MLP (one all-reduce); a MoE (one
    for the experts' partial sums, and two all-gathers over data: the
    gates for the top k and the f32 dispatched tokens)."""
    from repro_torch.models.config import (MAMBA, MAMBA_MOE, MLSTM,
                                           MOE_BLOCKS, SLSTM)
    per = {MLSTM: {"all-reduce": 1, "collective-permute": 4,
                   "reduce-scatter": 5},
           SLSTM: {"all-reduce": 1, "all-gather": 1}}
    want = {"all-reduce": 1}
    for period, reps in cfg.stages():
        for bt in period * reps:
            if bt in per:
                add = per[bt]
            else:
                add = {"all-reduce": 2}          # the block and its FFN
                if bt in (MAMBA, MAMBA_MOE):
                    add = {"all-reduce": 3, "collective-permute": 4}
                if bt in MOE_BLOCKS:
                    add = dict(add, **{"all-gather": 2})
            for k, v in add.items():
                want[k] = want.get(k, 0) + v
    return want


def dryrun_phase():
    """The dry-run of six pairs on the simulated single-pod mesh, in a
    subprocess: it needs no card, and its fake process group is
    process-global."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", DRYRUN_CODE, json.dumps(DRYRUN_PAIRS)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(SRC)),
        capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        fail(f"dry-run: exit {out.returncode}: {out.stderr[-3000:]}")
    got = json.loads(out.stdout.strip().splitlines()[-1])
    print(f"dry-run: {len(got['records'])} pairs in "
          f"{time.perf_counter() - t0:.1f}s (the subprocess's start "
          f"included)", flush=True)
    if got["jax_loaded"]:
        fail("dry-run: jax was loaded")
    for rec in got["records"]:
        what = f"dry-run {rec.get('arch')} x {rec.get('shape')}"
        if set(rec) != DRYRUN_KEYS:
            fail(f"{what}: keys {sorted(set(rec) ^ DRYRUN_KEYS)} missing "
                 "or extra")
        print(f"{what} x {rec['mesh']} ({rec['devices']} devices, "
              f"{rec['mode']}): per device argument "
              f"{rec['memory']['argument_bytes']} bytes, output "
              f"{rec['memory']['output_bytes']} bytes, {rec['flops']:.4e} "
              f"FLOPs counted; collectives {json.dumps(rec['collectives'])}"
              f"; roofline {json.dumps(rec['roofline'])}", flush=True)
        want = DRYRUN_TRAIN_EXPECTED.get((rec["arch"], rec["shape"])) or \
            dryrun_expected(get_config(rec["arch"]))
        have = {k: v["count"] for k, v in rec["collectives"].items()}
        if have != want:
            fail(f"{what}: collectives {have}, expected {want} "
                 "(dryrun_expected, DRYRUN_TRAIN_EXPECTED)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also print where a serving step's time goes")
    args = ap.parse_args()
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
    # phi3.5-moe's shapes (GQA group 4), new to serving in this run
    phi = (32, 8, HD)
    check_decode(torch, dec, gen, DECODE_LENGTHS, flush,
                 "B=16 mixed, phi3.5-moe H=32 KV=8", shape=phi)
    check_prefill(torch, pre, gen, [0, 1024, 3584, 0], [512, 300, 512, 0],
                  512, flush, shape=phi)
    four_kernel_rows(torch, dec, pre, gen, flush)

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
    # whisper-base's decoder self-attention (H = KV = 8, hd 64) and jamba's
    # attention layer (H=64, KV=8), new to serving in this run
    for label, case, shape in (
            ("whisper chunk", (1, 512, 2048, 1536, 0, 0.0), (8, 8, 64)),
            ("whisper decode", (1, 1, 2048, 2047, 0, 0.0), (8, 8, 64)),
            ("whisper cache-less", (1, 448, 448, 0, 0, 0.0), (8, 8, 64)),
            ("jamba chunk", (1, 512, 2048, 1536, 0, 0.0), (64, 8, HD)),
            ("jamba decode", (1, 1, 2048, 2047, 0, 0.0), (64, 8, HD))):
        check_dense(torch, dense, gen, *case, flush, label, shape=shape)
    rows["prefill_attention"] = dict(dense_rows["chunk"], **{
        f"decode_{key}": dense_rows["decode"][src] for key, src in (
            ("kernel_ms", "ms"), ("plain_ms", "plain_ms"),
            ("bound_ms", "bound_ms"), ("library_ms", "library_ms"),
            ("max_err", "max_abs_err"))})

    del scratch

    phase("serve")
    executor, counts, classifier, engine_cfg = serve_phase(
        torch, 20, breakdown=args.profile)
    launches = {"qwen2-vl-2b": counts}
    phase("model check")
    model_check(torch, executor, "qwen2-vl-2b")
    if args.profile:
        phase("profile")
        profile_phase(torch, executor)
        prefill_profile_phase(torch, executor)
    phase("fleet migration")
    launches["qwen2-vl-2b fleet migration"] = fleet_migration_phase(
        torch, executor, classifier, engine_cfg)
    gc.collect()
    torch.cuda.empty_cache()
    phase("fleet serve")
    launches["qwen2-vl-2b fleet serve"] = fleet_serve_phase(
        torch, executor, classifier, engine_cfg)
    # free qwen2-vl and its replicas before gemma3-27b's 57 GB
    del executor, classifier
    gc.collect()
    torch.cuda.empty_cache()

    phase("legacy parity")
    launches[f"{PARITY_ARCH} legacy parity"] = legacy_parity_phase(torch)
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

    from repro_torch.configs import get_config
    launches["gemma3-27b"] = g_counts
    phase(f"phi3.5-moe serve ({PHI_LAYERS} of 32 layers)")
    phi_cfg = dataclasses.replace(get_config(PHI), num_layers=PHI_LAYERS)
    m_executor, launches[PHI] = family_serve_phase(
        torch, f"{PHI} ({PHI_LAYERS} of 32 layers)", phi_cfg, 12,
        max_len=4096, dense=False, check=lambda ex, c: need(
            "phi3.5-moe", c, launched=("paged_attention",
                                       "paged_prefill_attention")))
    phase("phi3.5-moe model check")
    model_check(torch, m_executor, "phi3.5-moe")
    moe_block_check(torch, m_executor)
    del m_executor
    gc.collect()
    torch.cuda.empty_cache()

    phase(f"jamba serve ({JAMBA_LAYERS} of 72 layers)")
    jamba_cfg = dataclasses.replace(get_config(JAMBA),
                                    num_layers=JAMBA_LAYERS)
    j_executor, launches[JAMBA] = family_serve_phase(
        torch, f"{JAMBA} ({JAMBA_LAYERS} of 72 layers)", jamba_cfg, 6,
        max_len=2048, dense=True,
        check=lambda ex, c: need("jamba", c, launched=("prefill_attention",),
                                 idle=("paged_attention",
                                       "paged_prefill_attention")))
    phase("jamba mamba_block check")
    mamba_check(torch, j_executor)
    del j_executor
    gc.collect()
    torch.cuda.empty_cache()

    phase("whisper-base serve")
    w_executor, launches["whisper-base"] = family_serve_phase(
        torch, "whisper-base (full)", get_config("whisper-base"), 8,
        max_len=2048, dense=True, check=lambda ex, c: need(
            "whisper", c, launched=("prefill_attention",),
            idle=("paged_attention", "paged_prefill_attention")))
    print(f"whisper-base: prefill_attention launched "
          f"{launches['whisper-base']['prefill_attention']} times at hd "
          f"{w_executor.cfg.hd}", flush=True)
    del w_executor

    phase("xlstm-125m serve")
    x_executor, launches["xlstm-125m"] = family_serve_phase(
        torch, "xlstm-125m (full)", get_config("xlstm-125m"), 6,
        max_len=1024, dense=True, check=lambda ex, c: need(
            "xlstm", c, idle=tuple(c)))
    del x_executor
    gc.collect()
    torch.cuda.empty_cache()

    four_serve_phases(torch, launches)

    # training runs no kernel: no kernel has a backward (kernels/ops.py)
    phase("train check")
    launches["train check"] = train_check_phase(torch)
    gc.collect()
    torch.cuda.empty_cache()
    phase(f"train {QWEN}")
    launches[f"train {QWEN}"] = train_qwen_phase(torch, args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    phase("train xlstm-125m")
    launches["train xlstm-125m"] = train_xlstm_phase(torch)
    phase("dry-run")
    dryrun_phase()

    for model, c in launches.items():
        print(f"launches, {model}: {c}")
    total = {name: sum(c[name] for c in launches.values())
             for name in counts}

    kernels = [
        dict(name="paged_attention", route="cuda",
             source="src/repro_torch/csrc/paged_attention.cu",
             replaces="src/repro/kernels/paged_attention.py:78",
             launches=total["paged_attention"],
             **rows["paged_attention"]),
        dict(name="paged_prefill_attention", route="cuda",
             source="src/repro_torch/csrc/paged_prefill_attention.cu",
             replaces="src/repro/kernels/paged_prefill_attention.py:91",
             launches=total["paged_prefill_attention"],
             **rows["paged_prefill_attention"]),
        dict(name="prefill_attention", route="cuda",
             source="src/repro_torch/csrc/prefill_attention.cu",
             replaces="src/repro/kernels/prefill_attention.py:69",
             launches=total["prefill_attention"],
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
