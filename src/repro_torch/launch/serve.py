"""Serving launcher: run the TCM-Serve engine on a workload.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-2b \
      --policy tcm --mix MH --rate 2.0 --num-requests 200 --executor sim

Executors:
  sim  — cost model derived from the FULL assigned architecture (A100-class
         coefficients); workload-scale scheduler experiments.
  real — the torch model (the reduced config unless ``--full``) on the
         GPU, with attention through the hand-written paged kernels;
         ``--device cpu`` runs it on the CPU through their plain versions.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.classifier import NaiveClassifier, SmartClassifier
from repro_torch.core.estimator import ImpactEstimator
from repro_torch.core.profiler import WorkloadProfiler
from repro_torch.core.scheduler import make_policy
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.executors import ExecutorConfig, ModelExecutor, \
    SimExecutor, cost_model_for_arch, make_cost_model
from repro_torch.serving.metrics import fmt_table, goodput, summarize
from repro_torch.serving.workload import WorkloadConfig, generate, \
    profiling_workload


def build_stack(arch: str, executor_kind: str = "sim", *,
                naive_classifier: bool = False, model_preset: str | None = None,
                kv_pages: int | None = None, token_budget: int = 512,
                slo_scale: float = 5.0, full: bool = False,
                max_len: int = 256, device="cuda"):
    """(executor, classifier, engine_cfg, profile, estimator) for one model.

    Real mode takes the reduced config unless ``full`` (the assigned
    configuration at its published widths), and warms the executor up
    before profiling starts, so the first profiled request does not pay
    the kernels' build and the device's start-up.
    """
    if executor_kind == "sim":
        cm = (make_cost_model(model_preset) if model_preset
              else cost_model_for_arch(get_config(arch)))
        executor = SimExecutor(cm)
        prof_reqs = profiling_workload()
    elif executor_kind == "real":
        # An explicit kv_pages sizes the executor's paged stores directly —
        # KV capacity decoupled from the max_slots x max_len slot geometry
        exec_cfg = ExecutorConfig(
            max_slots=16, max_len=max_len, num_pages=kv_pages).resolved()
        model_cfg = get_config(arch) if full else get_reduced(arch)
        executor = ModelExecutor(model_cfg, exec_cfg, device=device)
        warm_up(executor)
        prof_reqs = profiling_workload(n_per_modality=8)
        # real mode: the engine's KV capacity IS the resolved executor
        # capacity — one derivation (ExecutorConfig.resolved), so the
        # admission path and the paged stores agree by construction
        kv_pages = exec_cfg.num_pages
    else:
        raise NotImplementedError(
            f"executor {executor_kind!r} is not ported yet (ROADMAP.md: "
            "dense slot cache and the legacy executor)")
    profile = WorkloadProfiler(executor, arch).build(prof_reqs)
    est = ImpactEstimator.train(profile)
    classifier = (NaiveClassifier(est) if naive_classifier
                  else SmartClassifier.train(est, profile))
    cfg_kwargs = dict(token_budget=token_budget, slo_scale=slo_scale)
    if kv_pages is not None:
        cfg_kwargs["kv_pages"] = kv_pages
    engine_cfg = EngineConfig(**cfg_kwargs)
    return executor, classifier, engine_cfg, profile, est


def warm_up(executor: ModelExecutor) -> None:
    """One short prefill and one decode step through the executor's own
    path (builds the kernels, starts the device, fills allocator caches)
    with its pages released afterwards."""
    from repro_torch.serving.request import Modality, Request, State
    req = Request(rid="__warmup__", modality=Modality.TEXT, arrival=0.0,
                  text_tokens=8, prompt_tokens=8, output_tokens=2)
    alloc = executor.allocator
    alloc.allocate(req.rid, req.prompt_tokens + 2)
    try:
        executor.run_iteration([(req, req.prompt_tokens)], [], [])
        req.prefilled, req.decoded = req.prompt_tokens, 1
        req.state = State.RUNNING
        executor.run_iteration([], [req], [])
    finally:
        alloc.free(req.rid)
        req.state = State.FINISHED
        executor.release_slot(req)
        executor.emitted.pop(req.rid, None)
        executor.recompile_keys.clear()


def serve(arch: str, policy: str, workload: WorkloadConfig, *,
          executor_kind: str = "sim", naive_classifier: bool = False,
          model_preset: str | None = None, kv_pages: int | None = None,
          token_budget: int = 512, slo_scale: float = 5.0, **real_kwargs):
    """Build the stack and run the engine on ``workload``; ``real_kwargs``
    (``full``, ``max_len``, ``device``) go to
    ``build_stack``. Returns (finished requests, engine)."""
    executor, classifier, engine_cfg, _, _ = build_stack(
        arch, executor_kind, naive_classifier=naive_classifier,
        model_preset=model_preset, kv_pages=kv_pages,
        token_budget=token_budget, slo_scale=slo_scale, **real_kwargs)
    engine = Engine(make_policy(policy), executor, classifier, engine_cfg)
    reqs = generate(workload)
    done = engine.run(reqs)
    return done, engine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-vl-2b")
    ap.add_argument("--policy", default="tcm",
                    choices=["fcfs", "edf", "static", "naive-aging", "tcm"])
    ap.add_argument("--mix", default="MH", choices=["T0", "ML", "MH"])
    ap.add_argument("--rate", type=float, default=2.0)
    ap.add_argument("--num-requests", type=int, default=200)
    ap.add_argument("--executor", default="sim", choices=["sim", "real"])
    ap.add_argument("--naive-classifier", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="real mode: the assigned config at full width")
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    wl = WorkloadConfig(mix=args.mix, rate=args.rate,
                        num_requests=args.num_requests, seed=args.seed)
    real = {}
    if args.executor == "real":
        real = dict(full=args.full, max_len=args.max_len, device=args.device)
    done, engine = serve(args.arch, args.policy, wl,
                         executor_kind=args.executor,
                         naive_classifier=args.naive_classifier, **real)
    s = summarize(done)
    print(fmt_table(s, f"{args.arch} | {args.policy} | {args.mix} "
                       f"@ {args.rate} rps ({args.executor})"))
    print(f"goodput: {goodput(done):.3f} req/s   engine iterations: "
          f"{engine.iterations}   simulated time: {engine.now:.1f}s")


if __name__ == "__main__":
    main()
