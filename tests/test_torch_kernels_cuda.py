"""Each hand-written CUDA kernel of the port against its plain torch
version, on the GPU: odd shapes the serving path does not reach (MQA,
G = 16, hd 256, hd % 8 != 0, softcap, tiny pages, length-0 rows and padding
queries). Marked ``gpu``; without a CUDA device every test skips. Run on
the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch


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
]
GPU_PREFILL = [  # (q_start, new_lens, Sq, H, KV, hd, page, P, softcap)
    ([0, 100, 7, 0], [200, 64, 130, 0], 256, 12, 2, 128, 16, 128, 0.0),
    ([5, 0], [33, 40], 40, 4, 2, 64, 4, 64, 50.0),
    ([3, 60], [21, 9], 24, 8, 1, 72, 8, 32, 0.0),
    ([0, 31], [70, 64], 96, 16, 1, 256, 16, 64, 0.0),
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
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.cpu().numpy(),
                               atol=2e-2, rtol=0)
    assert (out[ln == 0] == 0).all()


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
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.cpu().numpy(),
                               atol=2e-2, rtol=0)
    pad = torch.arange(Sq, device="cuda")[None, :] >= new_lens[:, None]
    assert (out[pad] == 0).all()
