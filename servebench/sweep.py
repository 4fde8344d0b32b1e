"""The knee of a cell's traffic: one stack, one window per rate.

    python servebench/sweep.py --workload qwen2-vl-2b.mh --seed 5 \
        --seconds 30 --rates 1.5,2,3,4

For each rate (the mix file's other parameters as they are) the window is
driven and drained as a run does, and the backlog, the requests due that
have no first token yet, is read from the harness's stamps once a second.
A rate is sustained when the backlog's least-squares slope over the
whole window is under 2% of the rate a second and the drain after the
window clears it within 2 s: the knee is the highest such rate. Each rate runs on its own seed, so no
request's identity repeats on the executor.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

from servebench import run as bench_run  # noqa: E402  (sets the paths)


def backlog_slope(served, seconds: float) -> tuple[float, list[int]]:
    import numpy as np
    ts = np.arange(1.0, seconds + 1e-9, 1.0)
    backlog = [sum(1 for s in served if s.due <= t and
                   (not s.token_times or s.token_times[0] > t))
               for t in ts]
    slope = float(np.polyfit(ts, np.array(backlog), 1)[0])
    return slope, backlog


def main(argv=None) -> int:
    import argparse
    bench_run.pin_cores()

    import torch

    from servebench import cells, generator, harness
    from servebench.metrics._common import p90
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    root = bench_run.ROOT
    bench = cells.benchmark(root)
    cell = cells.cell(bench, args.workload)
    cfg_file = cells.config(root, cell["config"])
    traffic = cells.traffic(root, cell["traffic"])
    t0 = time.perf_counter()
    executor, classifier, engine_cfg, parts = harness.build(
        torch, cfg_file, traffic, args.seed, "cuda", t0, root)
    print(f"{args.workload}: stack built in {time.perf_counter() - t0:.2f}"
          f" s ({parts}); {harness.card_line()}", flush=True)
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        seed = args.seed + 1000 * (k + 1)
        items = generator.window(traffic, seed, args.seconds, rate=rate)
        run = harness.Run(cell=cell, config=cfg_file,
                          model=harness.reference_config(cfg_file),
                          seconds=args.seconds, drain=True,
                          served=[harness.Served(it) for it in items],
                          traffic=traffic, drain_cap_s=float(traffic["drain_cap_s"]))
        harness.drive(torch, run, executor, classifier, engine_cfg,
                      trace=False, trace_start=0.0, trace_len=0.0)
        slope, backlog = backlog_slope(run.served, args.seconds)
        ttft = [run.ttft(s) for s in run.served]
        text = [run.ttft(s) for s in run.served
                if s.item.modality == "text"]
        toks = sum(1 for s in run.served for t in s.token_times
                   if t <= run.close)
        tpot = p90([(s.token_times[-1] - s.token_times[0]) /
                    (len(s.token_times) - 1) for s in run.served
                    if len(s.token_times) >= 2])
        failed = sum(s.failed for s in run.served)
        sustained = slope < 0.02 * rate and run.end - run.close < 2.0 \
            and not failed
        print(f"rate {rate}: {len(items)} requests, backlog slope "
              f"{slope:.4f}/s ({'sustained' if sustained else 'GROWS'}), "
              f"drain {run.end - run.close:.2f} s, failed {failed}; "
              f"ttft p90 {p90(ttft):.3f} s, text p90 {p90(text):.3f} s, "
              f"tpot p90 {tpot * 1e3:.1f} ms, {toks / args.seconds:.1f} "
              f"tokens/s in the window; backlog {backlog}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
