"""End to end: serve a REAL (reduced) torch model with batched
multimodal requests through the TCM engine, on the card unless
``--device cpu`` is given.

Every token is actually computed — the batched paged-KV execution path
runs each engine iteration as one packed prefill call plus one fused
decode step over the whole running set (block tables from the engine
allocator, greedy tokens fed back), attention through the hand-written
paged kernels on the card; engine timing comes from measured wall-clock.
Pass ``--executor real-legacy`` for the sequential per-request oracle the
batched path is held against.

  PYTHONPATH=src python -m repro_torch.examples.serve_real_model [--device cpu]
"""
import argparse

from repro_torch.launch.serve import serve
from repro_torch.serving.metrics import fmt_table, summarize
from repro_torch.serving.workload import WorkloadConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--executor", default="real",
                    choices=["real", "real-legacy"])
    args = ap.parse_args(argv)
    wl = WorkloadConfig(
        mix="MH", rate=20.0, num_requests=12, seed=3,
        # shrink sizes so the reduced model's 256-token window fits
        text_tokens_log_mu=3.0, text_tokens_log_sigma=0.5,
        image_patches=48, video_frames_min=2, video_frames_max=4,
        video_patches_per_frame=16,
        out_tokens_log_mu=2.0, out_tokens_log_sigma=0.3)

    done, engine = serve("qwen2-vl-2b", "tcm", wl,
                         executor_kind=args.executor, device=args.device)
    print(fmt_table(summarize(done),
                    f"real torch model (reduced qwen2-vl, {args.device}), TCM"))
    print(f"iterations={engine.iterations}  wall(sim)={engine.now:.2f}s  "
          f"completed={len(done)}/12")
    return done, engine


if __name__ == "__main__":
    main()
