"""The benchmark's frozen copies agree with what they were copied from:
the kernels' byte and operation counts with ``chip_smoke.py``'s printed
rows, the traffic generator with ``serving/workload.generate``, the
prompt rule with ``ModelExecutor._prompt_tokens``."""
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(REPO), str(REPO / "src")]

from servebench import generator, prompts, work  # noqa: E402

# chip_smoke.py's DECODE_LENGTHS, its B=16 decode over 256-page tables
LENGTHS = [0, 1, 15, 16, 17, 100, 511, 512, 1000, 2048, 2049, 3000, 4000,
           4095, 4096, 4096]


@pytest.mark.parametrize("lengths,h,want", [
    # "decode B=16 mixed, H=12 KV=2 hd=128" and the chatglm3-6b row
    (LENGTHS, 12, (26284096, 157016064)),
    (LENGTHS, 32, (26447936, 418709504)),
    # "decode B=1 context 4096"
    ([4096], 12, (4201476, 25165824)),
])
def test_decode_work_matches_chip_smoke(lengths, h, want):
    assert work.decode_work(lengths, h, 2, 128, len(lengths), 256) == want


@pytest.mark.parametrize("h,want", [
    (12, (18661408, 15052886016)),      # qwen2-vl-2b's prefill row
    (32, (39632928, 40141029376)),      # chatglm3-6b's
])
def test_prefill_work_matches_chip_smoke(h, want):
    got = work.prefill_work([0, 1024, 3584, 0], [512, 300, 512, 0], 512,
                            h, 2, 128, 4, 256)
    assert got == want


def test_step_flops_counts_rows():
    cfg = {"num_layers": 2, "d_model": 8, "num_heads": 2, "num_kv_heads": 1,
           "d_ff": 16, "vocab_size": 10}
    per_tok = 8 * 4 * 4 + 2 * 4 * 8 + 3 * 8 * 16
    assert work.linear_params(cfg) == per_tok
    # one decode row seeing 5 keys, emitting
    assert work.step_flops(cfg, [], [5], 1) == \
        2 * (2 * per_tok + 4 * 5 * 2 * 4) + 2 * 8 * 10
    # a 3-token chunk after 4 keys: pairs 5 + 6 + 7
    assert work.step_flops(cfg, [(4, 3)], [], 0) == \
        2 * (2 * 3 * per_tok + 4 * 18 * 2 * 4)
    assert work.bucket(5) == 8 and work.table_width(300, 4096, 16) == 256


@pytest.mark.parametrize("mix", ["MH", "T0"])
def test_generator_is_the_programs(mix):
    from repro_torch.serving.workload import WorkloadConfig, generate
    mine = generator.generate(generator.Mix(mix=mix, rate=3.0,
                                            num_requests=80, seed=9))
    theirs = generate(WorkloadConfig(mix=mix, rate=3.0, num_requests=80,
                                     seed=9))
    for a, b in zip(mine, theirs, strict=True):
        assert (a.rid, a.modality, a.arrival, a.text_tokens, a.mm_units,
                a.output_tokens, a.prompt_tokens, a.mm_hash) == \
            (b.rid, b.modality.value, b.arrival, b.text_tokens, b.mm_units,
             b.output_tokens, b.prompt_tokens, b.mm_hash)


def test_window_keeps_the_load_and_reorders_it():
    traffic = {"generator": {"mix": "MH", "rate": 4.0, "num_requests": 400},
               "base_seed": 3}
    a = generator.window(traffic, 1, 20.0)
    b = generator.window(traffic, 2 ** 31 + 7, 20.0)
    assert sorted(x.prompt_tokens for x in a) == \
        sorted(x.prompt_tokens for x in b)
    assert [x.prompt_tokens for x in a] != [x.prompt_tokens for x in b]
    assert abs(a[-1].arrival - b[-1].arrival) < 1e-9 <= 20.0 - a[-1].arrival
    assert generator.window(traffic, 1, 20.0) == a
    assert len({x.rid for x in a} & {x.rid for x in b}) == 0


def test_prompt_rule_is_the_programs():
    from repro_torch.configs import get_reduced
    from repro_torch.serving.executors import ExecutorConfig, ModelExecutor
    from repro_torch.serving.request import Modality, Request
    cfg = get_reduced("qwen2-vl-2b")
    ex = ModelExecutor(cfg, ExecutorConfig(max_len=128, num_pages=16),
                       device="cpu")
    for rid, mm, text in (("s5r00001", 0, 40), ("s5r00002", 30, 12)):
        h = f"image-s5-{rid}" if mm else None
        req = Request(rid=rid, modality=Modality.IMAGE if mm else
                      Modality.TEXT, arrival=0.0, text_tokens=text,
                      mm_units=mm, prompt_tokens=text + mm, mm_hash=h)
        chunks = prompts.content_chunks(rid, text + mm, mm, h)
        assert chunks == req.content_chunks()
        np.testing.assert_array_equal(
            prompts.prompt_tokens(rid, chunks, cfg.vocab_size),
            ex._prompt_tokens(req))


def test_roofline_readers_sum_bounds_over_the_kernels_device_time():
    from servebench import harness
    from servebench.metrics import (device_idle, mfu,
                                    paged_attention_roofline,
                                    paged_prefill_attention_roofline)
    model = {"num_layers": 2, "d_model": 1536, "num_heads": 12,
             "num_kv_heads": 2, "d_ff": 8960, "vocab_size": 151936}
    run = harness.Run(cell={}, config={"serving": {"page_size": 16,
                                                   "max_len": 32768}},
                      model=model, seconds=10.0, drain=True, served=[])
    run.close = 10.0
    run.steps = [harness.Step(1.0, 0.01, [(0, 512, 0), (1024, 300, 0)],
                              [100, 2000], 3, True),
                 harness.Step(2.0, 0.01, [], [50], 1, False)]
    run.admissions = [(1.5, 0.02, 700, True)]
    pre = sum(work.bound_s(*w) for w in (
        work.prefill_work([0, 1024], [512, 300], 512, 12, 2, 128, 2, 128),
        work.prefill_work([0], [700], 1024, 12, 2, 128, 1, 64))) * 2
    dec = work.bound_s(*work.decode_work([100, 2000], 12, 2, 128, 2,
                                         128)) * 2
    run.trace = {"busy_s": 0.25, "window_s": 1.0, "idle": {}, "kernels": {
        "void (anonymous namespace)::paged_prefill_wgmma_kernel<128>(x)":
            pre * 4,
        "void (anonymous namespace)::paged_split_kernel<128>(y)": dec * 3,
        "void pa::split::combine_kernel(z)": dec * 1,
        "nvjet_tst_192x128": 1.0}}
    assert paged_prefill_attention_roofline.read(run) == \
        pytest.approx(25.0)
    assert paged_attention_roofline.read(run) == pytest.approx(25.0)
    assert device_idle.read(run) == pytest.approx(75.0)
    flops = sum(work.step_flops(model, [(a, n) for a, n, _w in s.prefill],
                                s.decode, s.emitting) for s in run.steps)
    assert mfu.read(run) == pytest.approx(
        100 * flops / (0.02 * work.PEAK_FLOPS))
    run.trace["kernels"] = {}
    assert paged_prefill_attention_roofline.read(run) is None


def test_window_gives_every_seed_the_same_gaps():
    traffic = {"generator": {"mix": "MH", "rate": 4.0, "num_requests": 400,
                             "burst_prob": 0.05},
               "base_seed": 3}
    a = generator.window(traffic, 1, 20.0)
    b = generator.window(traffic, 2, 20.0)

    def gaps(w):
        return np.diff([0.0] + [x.arrival for x in w])

    np.testing.assert_allclose(np.sort(gaps(a)), np.sort(gaps(b)),
                               atol=1e-9)
    assert [x.arrival for x in a] != [x.arrival for x in b]


def test_latency_readers_stamp_from_the_due_time():
    from servebench import harness
    from servebench.metrics import tpot_p90_ms, ttft_p90_s, ttft_text_p90_s

    def served(mod, due, times, failed=False):
        it = generator.Item(rid="r", modality=mod, arrival=due,
                            text_tokens=1, mm_units=0, output_tokens=4,
                            prompt_tokens=1)
        return harness.Served(it, token_times=times, failed=failed)

    run = harness.Run(cell={}, config={}, model={}, seconds=10.0,
                      drain=True, served=[
                          served("text", 1.0, [1.2, 1.25, 1.3]),
                          served("text", 1.0, [1.6]),
                          served("video", 2.0, [5.0, 5.05]),
                          served("image", 3.0, [3.5, 3.8]),
                          served("text", 4.0, [], failed=True)])
    run.close = 10.0
    run.end = 12.0                 # the drain stopped: the failed one's TTFT
    ttfts = [0.2, 0.6, 3.0, 0.5, 8.0]
    assert ttft_p90_s.read(run) == pytest.approx(np.percentile(ttfts, 90))
    assert ttft_text_p90_s.read(run) == pytest.approx(
        np.percentile([0.2, 0.6, 8.0], 90))
    assert tpot_p90_ms.read(run) == pytest.approx(
        np.percentile([50.0, 50.0, 300.0], 90))
    run.traced_from = 2.5          # a traced run reads what came before
    assert ttft_p90_s.read(run) == pytest.approx(
        np.percentile([0.2, 0.6, 3.0], 90))
    assert ttft_text_p90_s.read(run) == pytest.approx(
        np.percentile([0.2, 0.6], 90))
    # the video's tokens came after the profiler opened
    assert tpot_p90_ms.read(run) == pytest.approx(50.0)
