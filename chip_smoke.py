"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py                # every phase
    python3 chip_smoke.py --profile      # plus where a step's time goes

Phases, each printing its own lines:
  1. the card's name and power limit (nvidia-smi);
  2. build the hand-written CUDA kernels from src/repro_torch/csrc;
  3. each kernel against its plain torch version at the serving path's
     shapes (H=12, KV=2, hd=128, page 16), with kernel, plain, library
     (SDPA over the gathered context) and lower-bound times;
  4. serve: full-width qwen2-vl-2b (28 layers, bf16, max_len 4096,
     16 slots, policy tcm) through repro_torch.launch.serve.build_stack —
     real profiler, estimator and classifier — then the engine on an MH
     workload; every request must finish with tokens, both kernels must
     have launched, and JAX must not be loaded;
  5. model check: the served weights, cut to two layers, give the same
     logits with attention through the kernels as through their plain
     torch versions, on a small input;
  6. a JSON line of every kernel's numbers, then the device JSON line last.

Exits non-zero, printing no result, when CUDA is unavailable or the
repository's sources are not beside this script, or when any check fails.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

H, KV, HD, PAGE = 12, 2, 128, 16
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
TOL = 2e-2


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


def check_decode(torch, mod, gen, lengths, flush):
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
    err = (out.float() - ref).abs().max().item()
    zero_rows = [i for i, n in enumerate(lengths) if n == 0]
    if zero_rows and out[zero_rows].abs().max().item() != 0.0:
        fail("decode: length-0 rows are not exact zeros")
    if not math.isfinite(err) or err > TOL:
        fail(f"decode B={B}: max_abs_err {err} > {TOL}")
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
    return _row(err, ms, plain_ms, lib_ms, bytes_, flops,
                f"decode B={B} contexts<= {max(lengths)}")


def check_prefill(torch, mod, gen, q_start, new_lens, Sq, flush):
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
    err = (out.float() - ref).abs().max().item()
    pad = torch.arange(Sq, device="cuda")[None, :] >= nl_t.long()[:, None]
    if pad.any() and out[pad].abs().max().item() != 0.0:
        fail("prefill: padding queries are not exact zeros")
    if not math.isfinite(err) or err > TOL:
        fail(f"prefill: max_abs_err {err} > {TOL}")
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
    return _row(err, ms, plain_ms, lib_ms, bytes_, flops,
                f"prefill B={B} Sq={Sq} q_start={q_start} "
                f"new_lens={new_lens}")


def _row(err, ms, plain_ms, lib_ms, bytes_, flops, label):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": lib_ms}
    print(f"{label}: max_err={err:.3e} kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
          f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}; "
          f"{bytes_} bytes, {flops} flops)", flush=True)
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
    for name, n in counts.items():
        if n <= 0:
            fail(f"serve: kernel {name} never launched on the main path")
    if "jax" in sys.modules:
        fail("serve: jax was imported")
    return executor, counts


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
    from repro_torch.kernels import paged_attention as dec
    from repro_torch.kernels import paged_prefill_attention as pre
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.params import tree_map

    class PlainOps:   # the kernels' plain versions, on the card
        paged_attention = staticmethod(dec.plain)
        paged_prefill_attention = staticmethod(pre.plain)

    full = executor.cfg
    if full.stages() != [((full.pattern()[0],), full.num_layers)]:
        fail("model check: expected one stacked stage")
    B, C, ppl = 2, 96, 16        # 2 rows x 7 pages, trash page 15
    gen = torch.Generator(device="cpu").manual_seed(7)
    toks = torch.randint(1, full.vocab_size, (B, C + 1), generator=gen)
    bt = torch.tensor([[i * 7 + j for j in range(7)] for i in range(B)],
                      dtype=torch.int32, device="cuda")
    cut = dict(executor.params, stages=[tree_map(
        lambda a: a[:depth], executor.params["stages"][0],
        is_leaf=torch.is_tensor)])
    cfg = dataclasses.replace(full, num_layers=depth)
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
                        cut, cfg, toks[:, start:start + n].cuda(),
                        positions=pos, cache=cache, attn_impl="kernel",
                        last_pos=new_lens - 1)
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


def profile_phase(torch, executor):
    """Where a serving step's time goes (``--profile`` only): a B=16
    decode step at context 2000 through the executor's own step, its host
    enqueue time against enqueue-plus-device time and a profiler table of
    its device time; then the decode kernel's time against context length
    at B=1 (its cost per 64-key tile)."""
    import numpy as np
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
                                        row_limit=8))
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

    phase("kernels vs plain")
    from repro_torch.kernels import paged_attention as dec
    from repro_torch.kernels import paged_prefill_attention as pre
    gen = torch.Generator(device="cuda").manual_seed(0)
    scratch = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()
    rows = {}
    check_decode(torch, dec, gen, [4096], flush)
    rows["paged_attention"] = check_decode(
        torch, dec, gen, [0, 1, 15, 16, 17, 100, 511, 512, 1000, 2048, 2049,
                          3000, 4000, 4095, 4096, 4096], flush)
    rows["paged_prefill_attention"] = check_prefill(
        torch, pre, gen, [0, 1024, 3584, 0], [512, 300, 512, 0], 512, flush)
    del scratch

    phase("serve")
    executor, counts = serve_phase(torch, 20, breakdown=args.profile)
    phase("model check")
    model_check(torch, executor)
    if args.profile:
        phase("profile")
        profile_phase(torch, executor)

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
    ]
    print(f"total {time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
