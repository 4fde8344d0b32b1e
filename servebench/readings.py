"""The correctness check's two readings at a cell's own size: on each
seed, a short window at the cell's load, then the widest logit gap of the
program's served tokens against the float32 reference (the lower reading)
and of the fp8 control on the same requests (the upper reading).

    python servebench/readings.py --workload chatglm3-6b.chat \
        --seeds 11,12,13 --seconds 20

One process for every seed; each seed builds its own stack, as a run does.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

from servebench import run as bench_run  # noqa: E402  (sets the paths)


def main(argv=None) -> int:
    import argparse
    bench_run.pin_cores()

    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        res = bench_run.execute(
            torch, args.workload, seed, args.seconds, False, "cuda",
            t_start=t, log=lambda m: print(m, file=sys.stderr, flush=True),
            control=bool(args.control))
        ctl = res.get("control", {})
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "gap": res["checks"]["logit_gap"]["value"],
                          "control_gap": ctl.get("logit_gap"),
                          "program": ctl.get("program_per_request"),
                          "control": ctl.get("per_request"),
                          "tokens": res["checks"]["sampled_tokens"]["value"],
                          "attempted": res["attempted"],
                          "failed": res["failed"],
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
