"""Training launcher.

Trains a reduced config (or, with ``--full``, the full one) for a number
of steps on the synthetic packed-token pipeline, with checkpointing; the
xlstm-125m default is the full config at ``max_seq_len=--seq`` either
way. Runs on the GPU unless ``--device cpu`` is given; without CUDA the
default raises.

  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
      --steps 200 --batch 8 --seq 128
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.device import resolve_device, synchronize
from repro_torch.train.checkpoint import load, save
from repro_torch.train.data import PackedTokenDataset
from repro_torch.train.loop import make_train_state, train_step
from repro_torch.train.optimizer import leaves


def main(argv=None):
    """Parse ``argv`` (default ``sys.argv``), train, checkpoint; returns
    the final ``TrainState``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="use the full assigned config")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked for)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch) if args.full else get_reduced(args.arch)
    # xlstm-125m IS ~100M-scale and trainable at short seq as-is
    if args.arch == "xlstm-125m" and not args.full:
        cfg = dataclasses.replace(get_config(args.arch), max_seq_len=args.seq)

    state = make_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    if args.resume:
        state = load(args.resume, state)
    n = sum(x.numel() for x in leaves(state.params))
    print(f"arch={cfg.name} params={n/1e6:.1f}M layers={cfg.num_layers} "
          f"d_model={cfg.d_model}")

    data = PackedTokenDataset(cfg.vocab_size, args.seq)
    t0 = time.time()
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 data.batch(step, args.batch).items()}
        state, metrics = train_step(state, batch, cfg, base_lr=args.lr)
        if step % args.log_every == 0 or step == args.steps - 1:
            synchronize(dev)
            print(f"step {step:5d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"({(time.time()-t0)/(step+1):.2f}s/step)", flush=True)
    if args.ckpt:
        save(args.ckpt, state)
        print(f"checkpoint -> {args.ckpt}")
    return state


if __name__ == "__main__":
    main()
