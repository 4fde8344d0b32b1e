"""Sweep every runnable (arch x shape x mesh) dry-run in ONE process (the
fake process group is initialised once, at the largest mesh's size).
Skips pairs whose JSON already exists, so the sweep is resumable; the
pairs that fail are listed in FAILURES.json. A pair that runs past
``--pair-timeout`` seconds (600 by default) is stopped and listed there.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_all [--mesh single|multi|both]
"""
import argparse
import json
import os
import signal
import time
import traceback

from repro_torch.launch.dryrun import run_one, runnable_pairs
from repro_torch.launch.mesh import init_fake_group


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--only-arch", default=None)
    ap.add_argument("--pair-timeout", type=int, default=600,
                    help="seconds a pair may run (0: no limit)")
    args = ap.parse_args()
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    init_fake_group(512 if "multi" in meshes else 256)

    def out_of_time(signum, frame):
        raise TimeoutError(f"the pair ran past {args.pair_timeout}s")
    signal.signal(signal.SIGALRM, out_of_time)

    failures = []
    for mesh in meshes:
        for arch, shape in runnable_pairs():
            if args.only_arch and arch != args.only_arch:
                continue
            path = os.path.join(args.out, f"{arch}__{shape}__{mesh}.json")
            if os.path.exists(path):
                continue
            t0 = time.time()
            signal.alarm(args.pair_timeout)
            try:
                run_one(arch, shape, mesh, args.out)
            except Exception as e:  # record and continue
                failures.append((arch, shape, mesh, repr(e)))
                print(f"[FAIL] {arch} x {shape} x {mesh}: {e}")
                traceback.print_exc()
            finally:
                signal.alarm(0)
            print(f"  ({time.time()-t0:.0f}s)", flush=True)
    if failures:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "FAILURES.json"), "w") as f:
            json.dump(failures, f, indent=1)
        print(f"{len(failures)} failures")
    else:
        print("ALL PASS")


if __name__ == "__main__":
    main()
