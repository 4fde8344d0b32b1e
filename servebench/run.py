"""The port's serving benchmark: one run of one cell on one H100.

    python servebench/run.py --workload qwen2-vl-2b.mh --seed 7 \
        --seconds 51 --trace 0

builds the cell's stack, opens the window, drives it for ``--seconds`` in
an open loop, drains, checks what the timed path produced against a plain
float32 reference, and prints one JSON line last on standard output. With
``--trace 0`` its metrics are the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, from the same window with the harness's
timers, and a profiler over its last seconds (the host-clock readers leave
that part out).

Everything a cell is made of is found by name from ``BENCHMARK.json``
(``servebench/cells.py``). Nothing here imports ``jax`` or the JAX package
``repro``; a run that finds either loaded when the window has closed fails.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed place inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("USE_FLAX", "0")
# one busy thread: no idle pool of math threads spinning on the host cores
# the engine's loop runs on
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(var, "1")
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def pin_cores() -> None:
    """Keep the process on the same four cores in every run, from before
    torch allocates anything: a process that lands on other cores (and
    their memory) from one run to the next runs its host-bound steps at
    another speed."""
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:4])


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (the part before the first dot,
    compared whole) is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def latency_line(run) -> str:
    """The window's TTFT and TPOT quantiles by modality, for the record on
    standard error (the metrics are the readers')."""
    import numpy as np
    due = run.untraced()
    parts = []
    for label in ("all", "text", "image", "video"):
        group = [s for s in due if label in ("all", s.item.modality)]
        ttft = [t for t in map(run.ttft, group) if t is not None]
        tpot = [(s.token_times[-1] - s.token_times[0])
                / (len(s.token_times) - 1) * 1e3
                for s in group if len(s.token_times) >= 2]
        if ttft:
            parts.append(f"{label} n={len(group)} ttft_s p50 "
                         f"{np.percentile(ttft, 50):.4f} p90 "
                         f"{np.percentile(ttft, 90):.4f} mean "
                         f"{np.mean(ttft):.4f}" + (
                             f" tpot_ms p50 {np.percentile(tpot, 50):.2f} "
                             f"p90 {np.percentile(tpot, 90):.2f}"
                             if tpot else ""))
    return "latency: " + "; ".join(parts)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(torch, workload: str, seed: int, seconds: float, trace: bool,
            device, root: Path = ROOT, t_start: float = T_START,
            log=print, control: bool = False) -> dict:
    """One run; returns the result object (without printing it).
    ``control`` also reads the fp8 control on the same sampled requests
    (``result["control"]``; the benchmark's own runs never do)."""
    from servebench import cells, generator, harness, weights

    bench = cells.benchmark(root)
    cell = cells.cell(bench, workload)
    cfg_file = cells.config(root, cell["config"])
    traffic = cells.traffic(root, cell["traffic"])
    srv = cfg_file["serving"]
    items = generator.window(traffic, seed, seconds)
    too_long = [it.rid for it in items if it.prompt_tokens +
                it.output_tokens > srv["max_len"] - 8]
    if too_long:
        raise ValueError(f"requests past the context of {srv['max_len']}: "
                         f"{too_long[:5]}")
    executor, classifier, engine_cfg, parts = harness.build(
        torch, cfg_file, traffic, seed, device, t_start, root)
    setup_s = time.perf_counter() - t_start
    log(f"setup {setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()))
    if torch.device(device).type == "cuda":
        free, total = torch.cuda.mem_get_info()
        page_bytes = executor.cfg.num_layers * 2 * executor.cfg.num_kv_heads \
            * executor.cfg.hd * 2 * srv["page_size"]
        fit = (srv["gpu_memory_utilization"] * total - (total - free)) \
            // page_bytes + srv["kv_pages"]
        log(f"KV pool {srv['kv_pages']} pages of {page_bytes} bytes; "
            f"{int(fit)} would fit under {srv['gpu_memory_utilization']} "
            f"of {total} bytes")
        torch.cuda.reset_peak_memory_stats()
    run = harness.Run(cell=cell, config=cfg_file,
                      model=harness.reference_config(cfg_file),
                      seconds=seconds, drain=bool(traffic["drain"]),
                      served=[harness.Served(it) for it in items],
                      traffic=traffic, setup_s=setup_s,
                      drain_cap_s=float(traffic.get("drain_cap_s", 0.0)))
    trace_len = float(traffic.get("trace_seconds", 3.0))
    harness.drive(torch, run, executor, classifier, engine_cfg,
                  trace=trace, trace_start=max(0.0, seconds - trace_len),
                  trace_len=trace_len)
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    harness.served_tokens(executor, run)

    metrics = {}
    for m in cells.metrics_of(bench, workload, trace):
        if m["name"] == "setup_s" and not trace:
            metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            continue
        value = cells.reader(root, m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    log(latency_line(run))

    # the program's state is freed before the reference runs
    del executor, classifier, engine_cfg
    for s in run.served:
        s.req = None
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    corr = cfg_file["correct"]
    chosen = harness.sample(run, seed, corr["sample_tokens"],
                            corr["sample_requests"],
                            corr["reference_tokens"])
    ref = cells.reference(root, cfg_file)
    rcfg = harness.reference_config(cfg_file)
    t = time.perf_counter()
    flat = weights.make(ref.layout(rcfg), seed, device)
    got = harness.gaps(torch, ref, rcfg, flat, chosen)
    ctl = (harness.gaps(torch, ref, rcfg, flat, chosen, precision="fp8")
           if control else None)
    del flat
    ref_s = time.perf_counter() - t
    gap = max(got) if got else float("inf")
    n_tok = sum(len(s.tokens) for s in chosen)
    attempted = len(run.served)
    failed = sum(s.failed for s in run.served)
    checks = {
        "logit_gap": {"value": gap, "limit": corr["max_logit_gap"]},
        "sampled_tokens": {"value": n_tok, "limit": corr["min_tokens"]},
    }
    correct = (gap <= corr["max_logit_gap"] and n_tok >= corr["min_tokens"])
    log(f"reference: {len(chosen)} requests, {n_tok} served tokens, "
        f"{sum(s.item.prompt_tokens for s in chosen)} prompt tokens, "
        f"{ref_s:.2f} s; widest gap per request "
        + " ".join(f"{g:.4f}" for g in got))
    device_info = {"platform": "gpu" if torch.device(device).type == "cuda"
                   else "cpu",
                   "kind": (torch.cuda.get_device_name(0)
                            if torch.device(device).type == "cuda"
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": int(failed), "metrics": metrics,
              "device": device_info}
    if trace:
        tr = run.trace
        device_info["busy_s"] = tr["busy_s"]
        device_info["window_s"] = tr["window_s"]
        ops: dict[str, float] = {}
        for k, v in tr["kernels"].items():
            ops[harness.short_name(k)] = ops.get(harness.short_name(k),
                                                 0.0) + v
        result["breakdown"] = {
            "device_ops": sorted(([k, v] for k, v in ops.items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(([k, v] for k, v in tr["idle"].items()),
                                key=lambda kv: -kv[1])[:10]}
    if ctl is not None:
        result["control"] = {"logit_gap": max(ctl) if ctl else None,
                             "per_request": ctl, "program_per_request": got}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse(argv)
    pin_cores()
    try:
        import torch
    except ImportError as e:
        print(f"no torch: {e}", file=sys.stderr)
        return 2
    from servebench import cells
    chips = cells.cell(cells.benchmark(), args.workload).get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    from servebench import harness

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    result = execute(torch, args.workload, args.seed, args.seconds,
                     bool(args.trace), "cuda", log=log)
    bad = forbidden_modules()
    if bad:
        print(f"JAX or the JAX package is loaded: {bad}", file=sys.stderr)
        return 3
    print(f"run {time.perf_counter() - T_START:.1f} s", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(harness.card_line(), flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
