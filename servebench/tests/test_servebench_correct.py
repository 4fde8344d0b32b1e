"""The comparison that decides ``correct``, on the CPU at a tiny size of
each configuration: sound runs of the port pass, and the control (the
reference in fp8, in the program's place) reads above the limit on the
same sampled requests."""
import sys
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(REPO), str(REPO / "src"), str(Path(__file__).parent)]

import servebench_tiny  # noqa: E402
from servebench import run  # noqa: E402


@pytest.mark.parametrize("name,seed", [("chatglm3-6b", 31),
                                       ("qwen2-vl-2b", 2 ** 31 + 33)])
def test_port_passes_and_the_control_fails(tmp_path, name, seed):
    root = servebench_tiny.make_root(tmp_path, configs=(name,))
    res = run.execute(torch, f"{name}.tiny", seed, 2.5, False, "cpu",
                      root=root, t_start=time.perf_counter(),
                      log=lambda m: None, control=True)
    limit = servebench_tiny.LIMITS[name]
    assert res["correct"], res["checks"]
    assert res["checks"]["logit_gap"]["value"] <= limit
    assert res["control"]["logit_gap"] > limit
    assert res["failed"] == 0 and res["attempted"] > 5
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device"}
    assert list(res)[-1] == "checks"
