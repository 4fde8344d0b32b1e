"""Each hand-written CUDA kernel of the port against its plain torch
version, on the GPU: odd shapes the serving path does not reach (MQA,
G = 16, hd 256, hd % 8 != 0, softcap, tiny pages, length-0 rows and padding
queries), the decode kernels' split over keys (rows ending on a slice
boundary, all-empty rows), and the kernels at the serving widths
(qwen2-vl's and phi3.5-moe's paged shapes and the published head
groups of chatglm3-6b, deepseek-coder-33b, qwen1.5-110b and grok-1-314b,
gemma3's, whisper-base's and jamba's dense ones), the page-chain migration payload of a bf16 store
on the card, and each op's refusal of autograd. Marked
``gpu``; without a CUDA device every test skips. Run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch


def _assert_close(out, ref):
    """Within 2e-2 of the plain version, and within 1e-2 of its scale:
    for each query token, the rms error over its (heads, dims) outputs at
    most 1e-2 of the plain output's rms there (tokens whose plain output
    is all zero are left to the exact-zero checks). With random inputs an
    attention over thousands of keys has outputs of ~0.03, so only the
    relative limit sees a dropped tile or slice of keys."""
    out, ref = out.float().cpu(), ref.float().cpu()
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-2, rtol=0)
    d = (out - ref).flatten(-2).square().mean(-1).sqrt()
    r = ref.flatten(-2).square().mean(-1).sqrt()
    live = r > 0
    assert (d[live] <= 1e-2 * r[live]).all(), \
        (d[live] / r[live]).max().item()


def _decode_case(lens, H, KV, hd, page, P, seed):
    g = np.random.default_rng(seed)
    B = len(lens)
    maxp = max(1, -(-max(lens) // page))
    q = g.standard_normal((B, H, hd)).astype(np.float32)
    kp = g.standard_normal((P, page, KV, hd)).astype(np.float32)
    vp = g.standard_normal((P, page, KV, hd)).astype(np.float32)
    bt = g.integers(0, P, (B, maxp)).astype(np.int32)
    return q, kp, vp, bt, np.asarray(lens, np.int32)


def _prefill_case(q_start, new_lens, Sq, H, KV, hd, page, P, seed):
    g = np.random.default_rng(seed)
    B = len(q_start)
    total = max(s + n for s, n in zip(q_start, new_lens))
    maxp = max(1, -(-total // page))
    q = g.standard_normal((B, Sq, H, hd)).astype(np.float32)
    kp = g.standard_normal((P, page, KV, hd)).astype(np.float32)
    vp = g.standard_normal((P, page, KV, hd)).astype(np.float32)
    bt = np.stack([g.permutation(P)[:maxp] for _ in range(B)]).astype(
        np.int32)
    return (q, kp, vp, bt, np.asarray(q_start, np.int32),
            np.asarray(new_lens, np.int32))


GPU_DECODE = [  # (lens, H, KV, hd, page, P, softcap)
    ([0, 1, 15, 16, 17, 100, 333], 12, 2, 128, 16, 64, 0.0),
    ([7, 30, 64, 65], 4, 2, 64, 4, 64, 30.0),
    ([50, 3], 8, 1, 72, 8, 32, 0.0),          # hd % 8 != 0: scalar path
    ([129, 250], 16, 1, 256, 16, 64, 0.0),    # G = 16, hd = 256
    # phi3.5-moe's decode shapes: GQA group 4
    ([0, 1, 17, 300, 2048], 32, 8, 128, 16, 256, 0.0),
    # the published head groups of chatglm3-6b (G=16 at KV=2),
    # deepseek-coder-33b (G=7), qwen1.5-110b (G=8) and grok-1-314b (G=6,
    # softcap 30), hd 128, contexts to 4096
    ([0, 1, 17, 300, 2048, 4096], 32, 2, 128, 16, 512, 0.0),
    ([0, 5, 129, 1000, 4095], 56, 8, 128, 16, 512, 0.0),
    ([3, 64, 777, 2048], 64, 8, 128, 16, 256, 0.0),
    ([1, 250, 1500, 4096], 48, 8, 128, 16, 512, 30.0),
]
GPU_PREFILL = [  # (q_start, new_lens, Sq, H, KV, hd, page, P, softcap)
    ([0, 100, 7, 0], [200, 64, 130, 0], 256, 12, 2, 128, 16, 128, 0.0),
    ([5, 0], [33, 40], 40, 4, 2, 64, 4, 64, 50.0),
    ([3, 60], [21, 9], 24, 8, 1, 72, 8, 32, 0.0),
    ([0, 31], [70, 64], 96, 16, 1, 256, 16, 64, 0.0),
    # qwen2-vl's serving widths: a 512-token chunk at contexts to 4096
    ([0, 1024, 3584, 0], [512, 300, 512, 0], 512, 12, 2, 128, 16, 1024,
     0.0),
    ([13, 0], [7, 5], 8, 12, 2, 128, 16, 16, 0.0),   # Sq * G < 64 rows
    ([40, 3], [100, 61], 100, 16, 1, 64, 16, 32, 0.0),  # G = 16, mid-page
    # phi3.5-moe's serving widths: GQA group 4, a 512-token chunk
    ([0, 700, 0], [512, 200, 0], 512, 32, 8, 128, 16, 512, 0.0),
    # the four decoders' published head groups at hd 128: G=16 at KV=2
    # (BQ=8); G=7 (BQ=18, 126 of 128 rows), chunks ending mid-tile; G=8;
    # G=6 with softcap 30
    ([0, 700, 0], [512, 200, 0], 512, 32, 2, 128, 16, 512, 0.0),
    ([0, 1000, 37], [512, 300, 95], 512, 56, 8, 128, 16, 512, 0.0),
    ([3], [25], 25, 56, 8, 128, 16, 16, 0.0),
    ([0, 1024], [512, 512], 512, 64, 8, 128, 16, 512, 0.0),
    ([0, 300, 0], [512, 212, 0], 512, 48, 8, 128, 16, 512, 30.0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_DECODE, ids=str)
def test_cuda_paged_attention_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import paged_attention as dec
    lens, H, KV, hd, page, P, cap = case
    arrs = _decode_case(lens, H, KV, hd, page, P, seed=hd)
    q, kp, vp = (torch.from_numpy(a).cuda().to(torch.bfloat16)
                 for a in arrs[:3])
    bt, ln = (torch.from_numpy(a).cuda() for a in arrs[3:])
    out = dec.paged_attention(q, kp, vp, bt, ln, softcap=cap)
    torch.cuda.synchronize()
    ref = dec.plain(q.float(), kp.float(), vp.float(), bt, ln, softcap=cap)
    _assert_close(out, ref)
    assert (out[ln == 0] == 0).all()


def _boundary_lengths(B, KV, maxp, page):
    """B lengths: 255, 256, 257, then every slice boundary the decode plan
    picks for this table, then one key past each, one key short of each,
    and full rows, as far as B goes."""
    from repro_torch.kernels import paged_attention as dec
    from repro_torch.kernels import split
    n, chunk = dec.split_plan(B, KV, maxp * page, page)
    bounds = [a for a, _ in split.ranges(0, maxp * page, n, chunk)[1:]]
    lens = [255, 256, 257] + bounds + [b + 1 for b in bounds] + \
        [b - 1 for b in bounds] + [maxp * page] * B
    return lens[:B]


GPU_SPLIT = [  # (lens, maxp, H, KV, hd, page, softcap)
    # qwen2-vl's decode shapes: 255-257 and every boundary of the B = 16
    # plan (8 slices of 512 keys)
    (_boundary_lengths(16, 2, 256, 16), 256, 12, 2, 128, 16, 0.0),
    ([4096], 256, 12, 2, 128, 16, 0.0),           # B = 1: 16 slices
    ([0, 0, 0], 256, 12, 2, 128, 16, 0.0),        # all rows empty
    ([0, 300, 0, 1], 256, 8, 2, 64, 16, 0.0),     # hd 64
    ([2000, 17], 128, 12, 2, 128, 16, 30.0),      # softcap
    ([1000, 0, 513], 64, 8, 1, 72, 16, 0.0),      # FMA path, split
    ([700, 256], 48, 16, 1, 256, 16, 0.0),        # FMA path, hd 256
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_SPLIT, ids=str)
def test_cuda_paged_attention_split_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import paged_attention as dec
    lens, maxp, H, KV, hd, page, cap = case
    g = np.random.default_rng(len(lens) + maxp)
    B, P = len(lens), len(lens) * maxp + 8
    q = torch.from_numpy(g.standard_normal((B, H, hd))).float()
    kp = torch.from_numpy(g.standard_normal((P, page, KV, hd))).float()
    vp = torch.from_numpy(g.standard_normal((P, page, KV, hd))).float()
    q, kp, vp = (t.cuda().to(torch.bfloat16) for t in (q, kp, vp))
    bt = torch.from_numpy(g.permutation(P)[:B * maxp].reshape(B, maxp)
                          .astype(np.int32)).cuda()
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    assert dec.split_plan(B, KV, maxp * page, page)[0] > 1
    out = dec.paged_attention(q, kp, vp, bt, ln, softcap=cap)
    torch.cuda.synchronize()
    ref = dec.plain(q.float(), kp.float(), vp.float(), bt, ln, softcap=cap)
    _assert_close(out, ref)
    assert (out[ln == 0] == 0).all()
    assert torch.isfinite(out.float()).all()


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_PREFILL, ids=str)
def test_cuda_paged_prefill_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import paged_prefill_attention as pre
    qs, nl, Sq, H, KV, hd, page, P, cap = case
    arrs = _prefill_case(qs, nl, Sq, H, KV, hd, page, P, seed=hd)
    q, kp, vp = (torch.from_numpy(a).cuda().to(torch.bfloat16)
                 for a in arrs[:3])
    bt, q_start, new_lens = (torch.from_numpy(a).cuda() for a in arrs[3:])
    out = pre.paged_prefill_attention(q, kp, vp, bt, q_start, new_lens,
                                      softcap=cap)
    torch.cuda.synchronize()
    ref = pre.plain(q.float(), kp.float(), vp.float(), bt, q_start,
                    new_lens, softcap=cap)
    _assert_close(out, ref)
    pad = torch.arange(Sq, device="cuda")[None, :] >= new_lens[:, None]
    assert (out[pad] == 0).all()


GPU_DENSE = [  # (B, Sq, n_keys, Smax, H, KV, hd, q_start, window, softcap)
    (2, 40, 100, 128, 8, 1, 128, 60, 0, 0.0),        # MQA, slot-buffer view
    (1, 300, 500, 512, 32, 16, 128, 200, 64, 0.0),   # G = 2, window
    (2, 20, 20, 20, 16, 1, 64, 0, 0, 0.0),           # G = 16, cache-less
    (1, 512, 2048, 2048, 32, 16, 128, 1536, 1024, 0.0),
    (2, 24, 60, 64, 8, 4, 64, 36, 0, 50.0),          # softcap
    (1, 33, 43, 48, 4, 2, 256, 10, 16, 30.0),        # hd 256: FMA path
    (2, 9, 30, 32, 6, 3, 72, 21, 8, 0.0),            # hd 72: FMA path
    (1, 1, 2048, 2048, 32, 16, 128, 2047, 1024, 0.0),  # decode
    (1, 1, 2048, 2048, 32, 16, 128, 2100, 1024, 0.0),  # q_start > n_keys
    (2, 4, 200, 256, 8, 2, 128, 300, 0, 0.0),        # every key visible
    (1, 1, 2048, 2048, 32, 16, 128, 3500, 1024, 0.0),  # no key in window
    (1, 3, 50, 64, 8, 2, 64, 2000, 40, 0.0),         # mixed: last rows see none
    # gemma3's serving widths: a 512-query chunk over 2048 keys
    (1, 512, 2048, 2048, 32, 16, 128, 1536, 0, 0.0),
    (1, 512, 2048, 2048, 32, 16, 128, 1536, 1024, 0.0),
    (2, 100, 1100, 2048, 32, 16, 128, 1000, 0, 0.0),  # B = 2, n_keys < Smax
    (1, 70, 70, 70, 6, 1, 128, 0, 0, 0.0),          # G = 6, two dead rows
    # whisper-base's decoder self-attention: H = KV = 8, hd 64
    (1, 512, 1000, 2048, 8, 8, 64, 488, 0, 0.0),
    (2, 300, 300, 300, 8, 8, 64, 0, 0, 0.0),         # cache-less
    # jamba's attention layer: G = 8, a chunk
    (1, 512, 1536, 2048, 64, 8, 128, 1024, 0, 0.0),
]

GPU_DENSE_DECODE = [  # the decode route: Sq * G <= 16, split over keys
    (1, 1, 2048, 2048, 32, 16, 128, 2047, 0, 0.0),     # gemma3 decode
    (1, 1, 2048, 2048, 32, 16, 128, 2047, 1024, 0.0),  # window
    (3, 1, 2048, 2048, 32, 16, 128, 2047, 0, 0.0),     # B = 3
    (3, 1, 2048, 2048, 32, 16, 128, 2047, 1024, 0.0),  # B = 3, window
    (1, 1, 2048, 2048, 32, 16, 128, 2100, 1024, 0.0),  # past the buffer
    (1, 1, 2048, 2048, 32, 16, 128, 3500, 1024, 0.0),  # sees no key
    (1, 1, 1500, 2048, 32, 16, 128, 1499, 0, 50.0),    # softcap
    (2, 1, 1000, 1024, 8, 2, 64, 999, 0, 0.0),         # hd 64
    (2, 4, 900, 1024, 8, 2, 64, 896, 700, 0.0),        # Sq * G = 16
    (1, 1, 1500, 2048, 8, 8, 64, 1499, 0, 0.0),        # whisper, hd 64
    (1, 1, 2000, 2048, 64, 8, 128, 1999, 0, 0.0),      # jamba, G = 8
]


def _dense_case(B, Sq, n_keys, Smax, H, KV, hd, seed):
    g = np.random.default_rng(seed)
    q = g.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = g.standard_normal((B, Smax, KV, hd)).astype(np.float32)
    v = g.standard_normal((B, Smax, KV, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_DENSE, ids=str)
def test_cuda_prefill_attention_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import prefill_attention as dense
    B, Sq, n, Smax, H, KV, hd, q_start, window, cap = case
    q, k, v = (torch.from_numpy(a).cuda().to(torch.bfloat16)
               for a in _dense_case(B, Sq, n, Smax, H, KV, hd, seed=hd + n))
    k, v = k[:, :n], v[:, :n]          # views of the slot buffers
    out = dense.prefill_attention(q, k, v, q_start=q_start, window=window,
                                  softcap=cap)
    torch.cuda.synchronize()
    ref = dense.plain(q.float(), k.float(), v.float(), q_start=q_start,
                      window=window, softcap=cap)
    _assert_close(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_DENSE_DECODE, ids=str)
def test_cuda_prefill_attention_decode_route_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import prefill_attention as dense
    B, Sq, n, Smax, H, KV, hd, q_start, window, cap = case
    q, k, v = (torch.from_numpy(a).cuda().to(torch.bfloat16)
               for a in _dense_case(B, Sq, n, Smax, H, KV, hd,
                                    seed=hd + n + B))
    k, v = k[:, :n], v[:, :n]          # views of the slot buffers
    assert dense.decode_route(q, k, v)
    lo, hi = dense.key_range(n, Sq, q_start, window)
    assert dense.split_plan(B, KV, lo, hi)[0] > 1
    out = dense.prefill_attention(q, k, v, q_start=q_start, window=window,
                                  softcap=cap)
    torch.cuda.synchronize()
    ref = dense.plain(q.float(), k.float(), v.float(), q_start=q_start,
                      window=window, softcap=cap)
    _assert_close(out, ref)


@pytest.mark.gpu
def test_cuda_prefill_attention_decode_reads_a_fused_qkv_view():
    """One decode query over k and v as the columns of a fused
    (B, S, H + 2KV, hd) activation: the decode route on strided views."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import prefill_attention as dense
    B, S, H, KV, hd = 2, 1100, 8, 2, 128
    g = np.random.default_rng(6)
    qkv = torch.from_numpy(g.standard_normal(
        (B, S, H + 2 * KV, hd)).astype(np.float32)).cuda().to(torch.bfloat16)
    q = qkv[:, -1:, :H].contiguous()
    k, v = qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    assert dense.decode_route(q, k, v)
    for window in (0, 512):
        out = dense.prefill_attention(q, k, v, q_start=S - 1, window=window)
        torch.cuda.synchronize()
        ref = dense.plain(q.float(), k.float(), v.float(), q_start=S - 1,
                          window=window)
        _assert_close(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [  # (B, S, H, KV, hd, window)
    (2, 70, 8, 2, 128, 32),
    (1, 1536, 32, 16, 128, 1024),    # gemma3's cache-less chunk
    (1, 300, 8, 2, 64, 0),
], ids=str)
def test_cuda_prefill_attention_reads_a_fused_qkv_view(case):
    """k and v as the columns of a fused (B, S, H + 2KV, hd) activation, as
    the cache-less forward passes them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import prefill_attention as dense
    B, S, H, KV, hd, window = case
    g = np.random.default_rng(5)
    qkv = torch.from_numpy(g.standard_normal(
        (B, S, H + 2 * KV, hd)).astype(np.float32)).cuda().to(torch.bfloat16)
    q = qkv[:, :, :H].contiguous()
    k, v = qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    out = dense.prefill_attention(q, k, v, q_start=0, window=window)
    torch.cuda.synchronize()
    ref = dense.plain(q.float(), k.float(), v.float(), q_start=0,
                      window=window)
    _assert_close(out, ref)


@pytest.mark.gpu
def test_cuda_prefill_attention_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import prefill_attention as dense

    def t(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device="cuda")
    bad = [
        ((t(1, 4, 8, 64, dtype=torch.float32), t(1, 8, 2, 64),
          t(1, 8, 2, 64)), {}, "bfloat16"),
        ((t(1, 8, 4, 64).transpose(1, 2), t(1, 8, 2, 64), t(1, 8, 2, 64)),
         {}, "bad shapes|contiguous"),
        ((t(1, 4, 6, 64), t(1, 8, 4, 64), t(1, 8, 4, 64)), {}, "H % KV"),
        ((t(1, 4, 32, 64), t(1, 8, 1, 64), t(1, 8, 1, 64)), {}, "G <="),
        ((t(1, 4, 2, 512), t(1, 8, 2, 512), t(1, 8, 2, 512)), {}, "hd <="),
        ((t(1, 4, 4, 64), t(1, 8, 64, 2).transpose(2, 3),
          t(1, 8, 2, 64)), {}, "contiguous|bad shapes"),
        ((t(1, 4, 4, 64), t(1, 0, 2, 64), t(1, 0, 2, 64)), {}, "one key"),
        ((t(1, 4, 4, 64), t(1, 8, 2, 64), t(1, 8, 2, 64)),
         {"q_start": -1}, ">= 0"),
        ((t(1, 4, 4, 64), t(2, 8, 2, 64), t(2, 8, 2, 64)), {}, "match"),
        ((t(1, 4, 4, 64), t(1, 8, 2, 64).cpu(), t(1, 8, 2, 64)), {},
         "CUDA"),
    ]
    for args, kw, msg in bad:
        with pytest.raises(ValueError, match=msg):
            dense.check_inputs(*args, **kw)
    before = dense.launches
    with pytest.raises(ValueError):
        dense.prefill_attention(*bad[0][0])
    assert dense.launches == before


@pytest.mark.gpu
def test_cuda_page_payload_round_trip_is_bit_exact():
    """A bf16 paged store on the card: ``export_page_payload`` (the
    container's bits through an int16 view) then ``import_page_payload``
    at other page ids restores every byte, and the imported rows equal the
    exported ones on the device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get_reduced
    from repro_torch.serving.executors import ExecutorConfig, ModelExecutor
    ex = ModelExecutor(get_reduced("qwen2-vl-2b"),
                       ExecutorConfig(max_slots=2, max_len=64, num_pages=8),
                       device="cuda")
    stores = [s for stage in ex.stores for s in stage.values()]
    g = torch.Generator(device="cuda").manual_seed(0)
    for s in stores:
        assert s.k_pages.dtype == torch.bfloat16
        for a in (s.k_pages, s.v_pages):
            a.copy_(torch.randn(a.shape, generator=g, device="cuda"))
    blobs = ex.export_page_payload([1, 6])
    ex.import_page_payload([3, 0], blobs)
    assert ex.export_page_payload([3, 0]) == blobs
    for s in stores:
        rows = torch.arange(s.layers, device="cuda") * s.pages_per_layer
        for a in (s.k_pages, s.v_pages):
            assert torch.equal(a[rows + 3].view(torch.int16),
                               a[rows + 1].view(torch.int16))
            assert torch.equal(a[rows + 0].view(torch.int16),
                               a[rows + 6].view(torch.int16))


@pytest.mark.gpu
def test_cuda_ops_refuse_autograd():
    """On the card, each kernel op raises under autograd before it
    launches (no kernel has a backward, and its output, written through
    ctypes, has no autograd node), and launches under ``torch.no_grad()``
    on the same tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)
    q, k, pages = rand(2, 4, 4, 64), rand(2, 8, 2, 64), rand(4, 16, 2, 64)
    bt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, device="cuda")
    lens = torch.tensor([5, 20], dtype=torch.int32, device="cuda")
    calls = {
        "paged_attention": lambda q, kv: ops.paged_attention(
            q[:, 0].contiguous(), kv[0], kv[0], bt, lens),
        "paged_prefill_attention": lambda q, kv: ops.paged_prefill_attention(
            q, kv[0], kv[0], bt, lens * 0, lens.clamp(max=4)),
        "prefill_attention": lambda q, kv: ops.prefill_attention(
            q, kv[1], kv[1]),
    }
    for name, call in calls.items():
        for grad_q in (True, False):
            qq = q.clone().requires_grad_(grad_q)
            kv = (pages.clone().requires_grad_(not grad_q),
                  k.clone().requires_grad_(not grad_q))
            ops.reset_launch_counts()
            with pytest.raises(RuntimeError, match=name):
                call(qq, kv)
            assert ops.launch_counts()[name] == 0
            with torch.no_grad():
                out = call(qq, kv)
            torch.cuda.synchronize()
            assert ops.launch_counts()[name] == 1
            assert not out.requires_grad and torch.isfinite(out.float()).all()
