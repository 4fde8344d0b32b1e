"""The open loop and the discovery by name, on the CPU at a tiny size: a
stall in one step counts against every request that came due during it
(times run from the due time, not from ingest), and a configuration, a
mix and a metric added as files are found by their names."""
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(REPO), str(REPO / "src"), str(Path(__file__).parent)]

import servebench_tiny  # noqa: E402
from servebench import cells, generator, harness, run  # noqa: E402


def test_a_stall_counts_against_requests_due_during_it(tmp_path):
    root = servebench_tiny.make_root(tmp_path)
    cfg_file = cells.config(root, "chatglm3-6b-tiny")
    traffic = cells.traffic(root, "tiny")
    executor, classifier, engine_cfg, _ = harness.build(
        torch, cfg_file, traffic, 7, "cpu", time.perf_counter(), root)
    items = generator.window(traffic, 7, 3.0)
    r = harness.Run(cell={}, config=cfg_file,
                    model=harness.reference_config(cfg_file), seconds=3.0,
                    drain=True, served=[harness.Served(i) for i in items],
                    drain_cap_s=10.0)
    stall = []
    inner = executor.run_iteration

    def stalled(*a):
        now = time.perf_counter() - r.opened
        if not stall and now >= 1.0:
            time.sleep(1.0)
            stall.append((now, time.perf_counter() - r.opened))
        return inner(*a)

    executor.run_iteration = stalled
    harness.drive(torch, r, executor, classifier, engine_cfg, trace=False,
                  trace_start=0.0, trace_len=0.0)
    (t0, t1), = stall
    during = [s for s in r.served if t0 <= s.due < t1]
    assert len(during) >= 3
    for s in during:
        assert s.token_times[0] >= t1
        assert r.ttft(s) >= t1 - s.due
    assert all(s.token_times for s in r.served)


def test_files_added_are_found_by_name(tmp_path):
    root = servebench_tiny.make_root(tmp_path)
    (root / "servebench" / "metrics" / "requests_due.py").write_text(
        "def read(run):\n    return float(len(run.served))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "requests_due", "unit": "requests",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["chatglm3-6b.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run.execute(torch, "chatglm3-6b.tiny", 21, 2.0, False, "cpu",
                      root=root, t_start=time.perf_counter(),
                      log=lambda m: None)
    assert res["metrics"]["requests_due"]["value"] == res["attempted"] > 0
    assert cells.reader(root, "mfu.any").__file__.endswith("mfu.py")
    with pytest.raises(FileNotFoundError):
        cells.reader(root, "no_such_metric")
    with pytest.raises(KeyError):
        cells.cell(bench, "no.such.cell")


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for m in ("repro_torch.x", "reproducible", "jaxtyping", "repro.core",
              "jax.numpy", "flax"):
        monkeypatch.setitem(sys.modules, m, sys)
    bad = run.forbidden_modules()
    assert {"repro.core", "jax.numpy", "flax"} <= set(bad)
    assert not {"repro_torch.x", "reproducible", "jaxtyping"} & set(bad)


def test_a_run_loads_no_jax(tmp_path):
    root = servebench_tiny.make_root(tmp_path)
    code = (
        "import sys, time, torch\n"
        f"sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'src')!r}]\n"
        "from servebench import run\n"
        f"res = run.execute(torch, 'chatglm3-6b.tiny', 5, 1.5, True, 'cpu',"
        f" root=__import__('pathlib').Path({str(root)!r}),"
        " t_start=time.perf_counter(), log=lambda m: None)\n"
        "assert res['correct'], res\n"
        "print('FORBIDDEN', run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, str(REPO / "servebench" / "run.py"), "--workload",
         "qwen2-vl-2b.mh", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert "{" not in out.stdout
