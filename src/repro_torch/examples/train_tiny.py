"""End-to-end training: train the ~100M xLSTM (an assigned arch!) on
the synthetic packed-token pipeline for a few hundred steps, with
checkpoint save + resume; on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.examples.train_tiny [--steps 200] [--device cpu]
"""
import sys

from repro_torch.launch.train import main as train_main

DEFAULTS = ["--arch", "xlstm-125m", "--steps", "200", "--batch", "4",
            "--seq", "64", "--ckpt", "experiments/xlstm_125m.npz",
            "--log-every", "20"]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    return train_main(DEFAULTS + list(argv))


if __name__ == "__main__":
    main()
