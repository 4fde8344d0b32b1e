"""Quickstart: the full TCM-Serve pipeline in ~40 lines.

Profiles a model, trains the Impact Estimator + smart classifier, runs the
engine under a heavy multimodal mix with the TCM policy vs vLLM-style FCFS,
and prints the paper's headline comparison. The engine runs on the cost
model (``sim`` executor), so no model runs and no card is touched.

  PYTHONPATH=src python -m repro_torch.examples.quickstart
"""
from repro_torch.core.scheduler import make_policy
from repro_torch.launch.serve import build_stack
from repro_torch.serving.engine import Engine
from repro_torch.serving.metrics import fmt_table, summarize
from repro_torch.serving.workload import WorkloadConfig, generate


def main():
    # 1. profile the model + train estimator/classifier (paper §3.2-3.4)
    executor, classifier, engine_cfg, profile, estimator = build_stack(
        "qwen2-vl-2b", "sim", model_preset="llava-7b")

    # show what the classifier learned
    for mod, text, mm in [("text", 120, 0), ("text", 9000, 0),
                          ("image", 40, 576), ("video", 40, 196 * 64)]:
        vclass, est_s, est_kv = classifier.classify(mod, text, mm)
        print(f"{mod:6s} text={text:5d} mm={mm:6d} -> {vclass.value:11s} "
              f"(est prefill {est_s*1e3:7.1f} ms, est KV {est_kv:8.0f} tok)")

    # 2. serve a heavy multimodal mix with TCM vs FCFS (paper Fig. 10)
    wl = WorkloadConfig(mix="MH", rate=2.0, num_requests=200, seed=7,
                        video_frames_max=96)
    results = {}
    for policy in ["fcfs", "tcm"]:
        engine = Engine(make_policy(policy), executor, classifier, engine_cfg)
        done = engine.run(generate(wl))
        results[policy] = summarize(done)
        print()
        print(fmt_table(results[policy], f"policy={policy}"))

    f, t = results["fcfs"], results["tcm"]
    print(f"\nTTFT reduction: overall "
          f"{1 - t['overall']['ttft_avg']/f['overall']['ttft_avg']:.0%} "
          f"(paper: 54%), latency-critical "
          f"{1 - t['motorcycle']['ttft_avg']/f['motorcycle']['ttft_avg']:.0%} "
          f"(paper: 78.5%)")
    return results


if __name__ == "__main__":
    main()
