"""A run with its timed path broken underneath comes out not correct, on
the CPU at a tiny size: a step that leaves its state (the paged KV)
unchanged, half of a decode batch answered from the other half, and a
token altered where it is produced. (One card: no exchange between chips
to leave out.)"""
import sys
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(REPO), str(REPO / "src"), str(Path(__file__).parent)]

import servebench_tiny  # noqa: E402
from servebench import run  # noqa: E402


def _kv_unchanged(monkeypatch):
    from repro_torch.cache.paged import PagedStackStore
    monkeypatch.setattr(PagedStackStore, "write_slots",
                        lambda self, k, v, slots, *, layer: self)


def _wrap_decode(monkeypatch, change):
    from repro_torch.serving.executors import ModelExecutor
    inner = ModelExecutor._step

    def step(self, tokens, *args):
        out = inner(self, tokens, *args)
        return change(out, self) if tokens.shape[1] == 1 else out
    monkeypatch.setattr(ModelExecutor, "_step", step)


def _half_batch(monkeypatch):
    def change(out, ex):
        h = out.shape[0] // 2
        if h:
            out = out.clone()
            out[h:2 * h] = out[:h]
        return out
    _wrap_decode(monkeypatch, change)


def _token_altered(monkeypatch):
    _wrap_decode(monkeypatch,
                 lambda out, ex: (out + 1) % ex.cfg.vocab_size)


@pytest.mark.parametrize("fault", [_kv_unchanged, _half_batch,
                                   _token_altered])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    root = servebench_tiny.make_root(tmp_path)
    fault(monkeypatch)
    res = run.execute(torch, "chatglm3-6b.tiny", 41, 2.5, False, "cpu",
                      root=root, t_start=time.perf_counter(),
                      log=lambda m: None)
    assert not res["correct"], res["checks"]
    assert res["checks"]["logit_gap"]["value"] > \
        servebench_tiny.LIMITS["chatglm3-6b"]
