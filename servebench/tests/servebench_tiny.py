"""A cell small enough for the CPU: reduced configurations of the two
served models (two layers, d_model 256) and a mix of short prompts, in a
scratch root beside the benchmark's own readers and reference."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent

SIZES = {"num_layers": 2, "d_model": 256, "num_heads": 4, "num_kv_heads": 2,
         "d_ff": 512, "vocab_size": 512, "max_seq_len": 512}


def tiny_config(name: str, limit: float) -> dict:
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg["model"].update(SIZES, name=f"{name}-tiny")
    if "mrope_section" in cfg["reference"]:
        # the published [16, 24, 24] of 64 frequencies, at hd 64
        cfg["reference"]["mrope_section"] = [8, 12, 12]
    cfg["serving"].update(max_len=512, kv_pages=256)
    cfg["correct"].update(max_logit_gap=limit, min_tokens=20,
                          sample_tokens=60, sample_requests=6,
                          reference_tokens=4000)
    return cfg


TRAFFIC = {
    "generator": {"mix": "MH", "rate": 8.0, "num_requests": 400,
                  "text_tokens_log_mu": 3.5, "text_tokens_log_sigma": 0.8,
                  "text_tokens_max": 200, "mm_text_max": 32,
                  "image_patches": 48, "video_frames_min": 1,
                  "video_frames_max": 4, "video_patches_per_frame": 32,
                  "out_tokens_log_mu": 2.0, "out_tokens_log_sigma": 0.5,
                  "out_tokens_max": 16},
    "base_seed": 11, "drain": True, "drain_cap_s": 10.0,
    "trace_seconds": 0.5, "warm_requests": 4}

# the widest logit gap at these sizes: the port's CPU path read 0-0.0123
# over six seeds a configuration, the fp8 control 0.060-0.176 (CPU,
# torch 2.13): the limit lies between, nearer the lower reading
LIMITS = {"chatglm3-6b": 0.03, "qwen2-vl-2b": 0.03}


def make_root(tmp: Path, configs=("chatglm3-6b",), traffic=TRAFFIC,
              limits=LIMITS) -> Path:
    """A root with BENCHMARK.json naming one cell per configuration
    (``<config>.tiny``), their files, and the real readers and
    reference."""
    sb = tmp / "servebench"
    for d in ("configs", "traffic"):
        (sb / d).mkdir(parents=True, exist_ok=True)
    for d in ("metrics", "reference"):
        shutil.copytree(HERE / d, sb / d, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"], bench["workloads"] = [], []
    for name in configs:
        (sb / "configs" / f"{name}-tiny.json").write_text(
            json.dumps(tiny_config(name, limits[name])))
        bench["configs"].append({"name": f"{name}-tiny", "source": "-",
                                 "file": f"servebench/configs/{name}-tiny.json",
                                 "reduced": [], "why": "CPU test"})
        bench["workloads"].append({"name": f"{name}.tiny",
                                   "config": f"{name}-tiny",
                                   "traffic": "tiny", "chips": 1,
                                   "why": "CPU test"})
    (sb / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = cells
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
