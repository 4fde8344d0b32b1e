"""Run ONE (arch x shape) step on the simulated 512-device multi-pod
production mesh and print its roofline terms. Needs no card.

  PYTHONPATH=src python -m repro_torch.examples.dryrun_one [arch] [shape]
"""
import sys

from repro_torch.launch.dryrun import run_one


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    arch = argv[0] if len(argv) > 0 else "gemma3-27b"
    shape = argv[1] if len(argv) > 1 else "decode_32k"
    result = run_one(arch, shape, "multi", "experiments/dryrun")
    print("\nroofline:", result["roofline"])
    return result


if __name__ == "__main__":
    main()
