"""The port's attention kernels against the JAX package.

On the CPU the port's ``kernels.ops`` runs each kernel's plain torch
version; these tests hold those against the JAX oracles in
``repro.kernels.ref`` on the same seeded numpy inputs (the sweeps of
tests/test_kernels.py: GQA/MQA, softcap, length-0 rows, page-boundary
lengths, padding queries). Tolerances: 2e-5 in f32, 2e-2 in bf16. The
hand-written CUDA kernels themselves are held against the plain versions
on the GPU (tests/test_torch_kernels_cuda.py, and chip_smoke.py).
"""
import numpy as np
import pytest
import torch
from torch_parity import normal, rng

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# jitted: one compile per shape instead of one per eager op
_jref_decode = jax.jit(jref.ref_paged_attention, static_argnames="softcap")
_jref_prefill = jax.jit(jref.ref_paged_prefill_attention,
                        static_argnames="softcap")
_jref_dense = jax.jit(jref.ref_prefill_attention,
                      static_argnames=("q_start", "window", "softcap"))

DTYPES = {"f32": (None, torch.float32, 2e-5),
          "bf16": (None, torch.bfloat16, 2e-2)}


def _both(a: np.ndarray, dt):
    """The same values on both sides, rounded to the working dtype once.
    The JAX oracle upcasts its inputs to f32 before any arithmetic, so it
    gets them as f32 (exactly the rounded values): one compile per shape
    serves both dtypes."""
    tdt = DTYPES[dt][1]
    t = torch.from_numpy(a).to(tdt)
    return jnp.asarray(t.float().numpy()), t


def _close(j, t, dt):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j.astype(jnp.float32)),
                               atol=DTYPES[dt][2], rtol=0)


def _decode_case(lens, H, KV, hd, page, P, seed):
    g = rng(seed)
    B = len(lens)
    maxp = max(1, -(-max(lens) // page))
    q = normal(g, B, H, hd)
    kp = normal(g, P, page, KV, hd)
    vp = normal(g, P, page, KV, hd)
    bt = g.integers(0, P, (B, maxp)).astype(np.int32)
    return q, kp, vp, bt, np.asarray(lens, np.int32)


DECODE_CASES = [
    # (lens, H, KV, hd, page, P, softcap)
    ([0], 4, 2, 32, 4, 8, 0.0),                # empty row -> exact zeros
    ([3], 4, 2, 32, 4, 8, 0.0),                # shorter than a page
    ([4, 8], 4, 2, 32, 4, 8, 0.0),             # page boundaries
    ([32], 4, 2, 32, 4, 8, 0.0),               # full block table
    ([0, 3, 4, 32], 4, 2, 32, 4, 8, 0.0),      # ragged mix
    ([5, 17, 9], 8, 1, 64, 8, 16, 0.0),        # MQA
    ([12, 40], 8, 8, 64, 4, 16, 0.0),          # MHA
    ([7, 30], 6, 2, 128, 16, 8, 30.0),         # softcap, hd 128
]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_paged_attention_plain_matches_jax_ref(case, dt):
    lens, H, KV, hd, page, P, cap = case
    arrs = _decode_case(lens, H, KV, hd, page, P, seed=len(lens) * 7 + hd)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dt) for a in arrs[:3])
    bt, ln = arrs[3], arrs[4]
    out = ops.paged_attention(tq, tk, tv, torch.from_numpy(bt),
                              torch.from_numpy(ln), softcap=cap)
    ref = _jref_decode(jq, jk, jv, jnp.asarray(bt), jnp.asarray(ln),
                       softcap=cap)
    assert out.shape == tq.shape and out.dtype == tq.dtype
    _close(ref, out, dt)
    zero = ln == 0
    assert (out[torch.from_numpy(zero)] == 0).all()


def _prefill_case(q_start, new_lens, Sq, H, KV, hd, page, P, seed):
    g = rng(seed)
    B = len(q_start)
    total = max(s + n for s, n in zip(q_start, new_lens))
    maxp = max(1, -(-total // page))
    q = normal(g, B, Sq, H, hd)
    kp = normal(g, P, page, KV, hd)
    vp = normal(g, P, page, KV, hd)
    bt = np.stack([g.permutation(P)[:maxp] for _ in range(B)]).astype(
        np.int32)
    return (q, kp, vp, bt, np.asarray(q_start, np.int32),
            np.asarray(new_lens, np.int32))


PREFILL_CASES = [
    # (q_start, new_lens, Sq, H, KV, hd, page, P, softcap)
    ([0], [8], 8, 2, 2, 32, 4, 8, 0.0),                 # MHA, no history
    ([9, 0], [6, 3], 8, 4, 2, 32, 4, 12, 0.0),          # ragged + padding
    ([0, 5, 16], [16, 0, 16], 16, 4, 2, 64, 8, 12, 0.0),  # zero row
    ([3, 12], [5, 4], 8, 8, 1, 64, 4, 16, 0.0),         # MQA
    ([4, 20], [8, 7], 8, 6, 2, 128, 16, 8, 50.0),       # softcap, G=3
]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", PREFILL_CASES, ids=str)
def test_paged_prefill_plain_matches_jax_ref(case, dt):
    qs, nl, Sq, H, KV, hd, page, P, cap = case
    arrs = _prefill_case(qs, nl, Sq, H, KV, hd, page, P, seed=Sq + hd)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dt) for a in arrs[:3])
    bt, q_start, new_lens = arrs[3:]
    out = ops.paged_prefill_attention(
        tq, tk, tv, torch.from_numpy(bt), torch.from_numpy(q_start),
        torch.from_numpy(new_lens), softcap=cap)
    ref = _jref_prefill(
        jq, jk, jv, jnp.asarray(bt), jnp.asarray(q_start),
        jnp.asarray(new_lens), softcap=cap)
    assert out.shape == tq.shape and out.dtype == tq.dtype
    _close(ref, out, dt)
    pad = np.arange(Sq)[None, :] >= new_lens[:, None]
    assert (out[torch.from_numpy(pad)] == 0).all()


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (8, 0.0), (16, 50.0)])
def test_ref_prefill_attention_matches_jax(window, softcap):
    g = rng(3)
    B, Sq, Skv, H, KV, hd = 2, 16, 48, 4, 2, 64
    q, k, v = normal(g, B, Sq, H, hd), normal(g, B, Skv, KV, hd), \
        normal(g, B, Skv, KV, hd)
    out = tref.ref_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_start=32, window=window, softcap=softcap)
    ref = _jref_dense(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_start=32,
        window=window, softcap=softcap)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


def test_cpu_dispatch_runs_plain_and_counts_no_launch():
    ops.reset_launch_counts()
    q, kp, vp, bt, ln = (torch.from_numpy(a) for a in
                         _decode_case([5, 9], 4, 2, 32, 4, 8, seed=1))
    out = ops.paged_attention(q, kp, vp, bt, ln)
    np.testing.assert_array_equal(
        out.numpy(), tref.ref_paged_attention(q, kp, vp, bt, ln).numpy())
    g = rng(2)
    dq, dk, dv = (torch.from_numpy(normal(g, 1, n, h, 32))
                  for n, h in ((3, 4), (9, 2), (9, 2)))
    out = ops.prefill_attention(dq, dk, dv, q_start=6, window=4)
    np.testing.assert_array_equal(
        out.numpy(), tref.ref_prefill_attention(dq, dk, dv, q_start=6,
                                                window=4).numpy())
    assert ops.launch_counts() == {"paged_attention": 0,
                                   "paged_prefill_attention": 0,
                                   "prefill_attention": 0}


def test_other_devices_raise():
    q = torch.zeros((1, 4, 32), device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.paged_attention(q, q, q, q, q)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    from repro_torch.kernels import paged_attention as dec
    q, kp, vp, bt, ln = (torch.from_numpy(a) for a in
                         _decode_case([5], 4, 2, 32, 4, 8, seed=2))
    with pytest.raises(ValueError, match="CUDA"):
        dec.paged_attention(q, kp, vp, bt, ln)    # CPU tensors: no kernel
