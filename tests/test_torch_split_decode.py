"""The decode kernels' split over keys (flash-decoding), on the CPU.

The kernels themselves run only on the card (tests/test_torch_kernels_cuda.py
and chip_smoke.py); what surrounds them is held here:

- the host plans (``paged_attention.split_plan``,
  ``prefill_attention.key_range`` / ``split_plan``): the slices cover the
  key range exactly, start on a page (paged) or a 64-key tile (dense), and
  there is at least one;
- a torch mirror of the kernels' scheme (``csrc/decode_split.cuh``): per
  slice, four warps each take 16 keys of every 64-key tile with their own
  online softmax and the kernel's own mask value (-inf paged, the finite
  -1e30 dense), the warps merge, and the slices' (m, l, O) states merge as
  ``combine_kernel`` does, skipping a slice with l == 0. It must match the
  plain versions (``kernels.ref``) and the JAX oracles in f32 within 2e-5,
  the tolerance of tests/test_kernels.py, on length-0 rows (exact zeros),
  rows ending on a slice boundary, windowed decodes and the decode past
  the buffer (a uniform average over every key).
"""
import math

import numpy as np
import pytest
import torch
from torch_parity import normal, rng

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import paged_attention as dec  # noqa: E402
from repro_torch.kernels import prefill_attention as dense  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import split  # noqa: E402

_jref_decode = jax.jit(jref.ref_paged_attention, static_argnames="softcap")
_jref_dense = jax.jit(jref.ref_prefill_attention,
                      static_argnames=("q_start", "window", "softcap"))

TOL = 2e-5
WARPS, WARP_KEYS = 4, 16


# ---------------------------------------------------------------------------
# the host plans
# ---------------------------------------------------------------------------

def _check_slices(lo, hi, n_split, chunk, unit):
    rs = split.ranges(lo, hi, n_split, chunk)
    assert n_split >= 1 and len(rs) == n_split
    assert rs[0][0] == lo and rs[-1][1] == hi
    for (a, b), (c, _) in zip(rs, rs[1:]):
        assert b == c                    # contiguous: each key once
    assert all(a < b for a, b in rs)     # no empty slice
    assert all((a - lo) % unit == 0 for a, _ in rs)
    assert chunk % unit == 0
    if n_split > 1:
        assert chunk >= split.MIN_SPLIT_KEYS


@pytest.mark.parametrize("B,KV,maxp,page", [
    (16, 2, 256, 16), (1, 2, 256, 16), (4, 2, 8, 16), (1, 1, 1, 16),
    (3, 16, 128, 16), (64, 8, 512, 16), (2, 2, 22, 48), (5, 3, 7, 100),
    (1, 1, 300, 4), (200, 4, 64, 16)])
def test_paged_split_plan_covers_the_table_in_page_aligned_slices(
        B, KV, maxp, page):
    n, chunk = dec.split_plan(B, KV, maxp * page, page)
    _check_slices(0, maxp * page, n, chunk, page)
    if page <= split.TILE and split.TILE % page == 0:
        assert chunk % split.TILE == 0   # whole tiles too
    # about the target's blocks when the keys allow (rounding the slices
    # up to whole units may cost a few), and not many more
    if n * split.MIN_SPLIT_KEYS <= maxp * page // 2:
        assert B * KV * n >= split.TARGET_BLOCKS // 2
    assert B * KV * (n - 1) < split.TARGET_BLOCKS or n == 1


def test_paged_split_plan_at_the_serving_shapes():
    # qwen2-vl: KV = 2, page 16, table of 256 pages (max_len 4096)
    assert dec.split_plan(16, 2, 4096, 16) == (8, 512)
    assert dec.split_plan(1, 2, 4096, 16) == (16, 256)
    assert dec.split_plan(16, 2, 64, 16) == (1, 64)


def _visible(n_keys, Sq, q_start, window):
    """(Sq, n_keys) bool: which keys each query sees (the reference's mask)."""
    return tref.causal_mask(q_start, Sq, n_keys, window).numpy()


@pytest.mark.parametrize("n_keys,Sq,q_start,window", [
    (2048, 1, 2047, 0), (2048, 1, 2047, 1024), (2048, 1, 2100, 1024),
    (2048, 1, 3500, 1024), (2048, 1, 2100, 0), (50, 3, 2000, 40),
    (1000, 2, 1030, 40), (700, 4, 800, 0), (64, 8, 0, 0), (10, 1, 9, 3),
    (2000, 1, 1999, 1000)])
def test_dense_key_range_and_split_plan(n_keys, Sq, q_start, window):
    lo, hi = dense.key_range(n_keys, Sq, q_start, window)
    vis = _visible(n_keys, Sq, q_start, window)
    seen = np.flatnonzero(vis.any(0))
    if vis[-1].any():
        # every key some query sees, and nothing outside them
        assert (lo, hi) == (seen.min(), seen.max() + 1)
    else:
        assert (lo, hi) == (0, n_keys)   # the last query sees none
    for B, KV in ((1, 16), (3, 16), (1, 2), (8, 8)):
        n, chunk = dense.split_plan(B, KV, lo, hi)
        _check_slices(lo, hi, n, chunk, split.TILE)


def test_dense_decode_route_is_taken_for_the_decode_shapes():
    def bufs(Sq, H, KV, hd, S=64, n=40):
        q = torch.zeros((2, Sq, H, hd))
        kb = torch.zeros((2, S, KV, hd))
        return q, kb[:, :n], kb[:, :n]
    assert dense.decode_route(*bufs(1, 32, 16, 128))     # gemma3 decode
    assert dense.decode_route(*bufs(4, 8, 2, 64))        # Sq * G = 16
    assert not dense.decode_route(*bufs(5, 8, 2, 64))    # Sq * G = 20
    assert not dense.decode_route(*bufs(1, 8, 2, 72))    # FMA head dim
    q, k, v = bufs(1, 8, 2, 64)
    qkv = torch.zeros((2, 40, 8 + 2 * 2 + 1, 64))
    # key rows one element off the 16-byte grid: the FMA path
    off = torch.zeros(1 + 2 * 64 * 2 * 64)[1:].view(2, 64, 2, 64)[:, :40]
    assert not dense.decode_route(q, off, v)
    # the k/v columns of a fused QKV activation are aligned views
    assert dense.decode_route(q, qkv[:, :, 8:10], qkv[:, :, 10:12])


# ---------------------------------------------------------------------------
# the torch mirror of the kernels' scheme
# ---------------------------------------------------------------------------

def _merge(states):
    """Merge (m, l, O) states as the kernels do: weights exp(m - M) over
    the states with l > 0 (an empty state is skipped, never weighted)."""
    ms = torch.stack([s[0] for s in states])
    ls = torch.stack([s[1] for s in states])
    os_ = torch.stack([s[2] for s in states])
    live = ls > 0
    M = torch.where(live, ms, torch.full_like(ms, -math.inf)).amax(0)
    c = torch.where(live, torch.exp(ms - M), torch.zeros_like(ms))
    return M, (c * ls).sum(0), (c[..., None] * os_).sum(0)


def _mirror(q, k, v, vis, end, lo, hi, n_split, chunk, masked, softcap):
    """q (B, KV, R, hd); k, v (B, KV, T, hd); vis (R, T) bool; end (B,)
    keys below end are live (the row's length, or hi); slices of the plan
    over [lo, hi). Returns (B, KV, R, hd)."""
    B, KV, R, hd = q.shape
    T = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    slices = []
    for k0, k1 in split.ranges(lo, hi, n_split, chunk):
        warps = []
        for w in range(WARPS):
            m = torch.full((B, KV, R), -math.inf)
            l = torch.zeros((B, KV, R))
            o = torch.zeros((B, KV, R, hd))
            for t0 in range(k0, k1, split.TILE):
                keys = t0 + w * WARP_KEYS + torch.arange(WARP_KEYS)
                live = (keys[None] < k1) & (keys[None] < end[:, None])
                kc = keys.clamp(max=T - 1)
                s = torch.einsum("bkrd,bktd->bkrt", q, k[:, :, kc]) * scale
                if softcap > 0:
                    s = torch.tanh(s / softcap) * softcap
                s = torch.where(vis[:, kc][None, None], s,
                                torch.full_like(s, masked))
                s = torch.where(live[:, None, None], s,
                                torch.full_like(s, -math.inf))
                m_new = torch.maximum(m, s.amax(-1))
                none = m_new == -math.inf
                alpha = torch.where(none, torch.ones_like(m),
                                    torch.exp(m - m_new))
                p = torch.where(none[..., None], torch.zeros_like(s),
                                torch.exp(s - m_new[..., None]))
                l = l * alpha + p.sum(-1)
                o = o * alpha[..., None] + torch.einsum(
                    "bkrt,bktd->bkrd", p, v[:, :, kc])
                m = m_new
            warps.append((m, l, o))
        slices.append(_merge(warps))
    _, l, o = _merge(slices)
    return torch.where(l[..., None] > 0, o / l.clamp(min=1e-30)[..., None],
                       torch.zeros_like(o))


def _paged_case(lens, H, KV, hd, page, maxp, seed):
    g = rng(seed)
    B = len(lens)
    P = B * maxp + 3
    q = normal(g, B, H, hd)
    kp, vp = normal(g, P, page, KV, hd), normal(g, P, page, KV, hd)
    bt = g.permutation(P)[:B * maxp].reshape(B, maxp).astype(np.int32)
    return q, kp, vp, bt, np.asarray(lens, np.int32)


def _paged_mirror(q, kp, vp, bt, ln, softcap):
    B, H, hd = q.shape
    _, page, KV, _ = kp.shape
    G, T = H // KV, bt.shape[1] * page
    n, chunk = dec.split_plan(B, KV, T, page)
    k = kp[bt.long()].reshape(B, T, KV, hd).permute(0, 2, 1, 3)
    v = vp[bt.long()].reshape(B, T, KV, hd).permute(0, 2, 1, 3)
    vis = torch.ones((G, T), dtype=torch.bool)
    out = _mirror(q.reshape(B, KV, G, hd), k, v, vis, ln.long().clamp(max=T),
                  0, T, n, chunk, -math.inf, softcap)
    return out.reshape(B, H, hd), n, chunk


PAGED_CASES = [  # (lens, H, KV, hd, page, maxp, softcap, min_split_keys)
    # table of 1024 keys: four slices of 256, boundaries 256, 512, 768
    ([0, 255, 256, 257, 512, 1, 1024, 769], 4, 2, 16, 16, 64, 0.0, 256),
    ([0, 0, 0], 4, 2, 16, 16, 64, 0.0, 256),            # all rows empty
    ([1000, 300], 6, 2, 32, 16, 64, 30.0, 256),         # softcap, G = 3
    ([1056, 47, 48, 49, 0], 4, 1, 16, 48, 22, 0.0, 256),  # page 48
    # short slices (64 keys): boundaries every tile
    ([63, 64, 65, 128, 129, 0, 191], 8, 2, 16, 4, 48, 0.0, 64),
    ([5, 17], 4, 4, 16, 4, 8, 0.0, 256),                # one slice
]


@pytest.mark.parametrize("case", PAGED_CASES, ids=str)
def test_split_mirror_matches_paged_references(case, monkeypatch):
    lens, H, KV, hd, page, maxp, cap, min_keys = case
    monkeypatch.setattr(split, "MIN_SPLIT_KEYS", min_keys)
    arrs = _paged_case(lens, H, KV, hd, page, maxp, seed=hd + maxp)
    q, kp, vp, bt, ln = (torch.from_numpy(a) for a in arrs)
    out, n, chunk = _paged_mirror(q, kp, vp, bt, ln, cap)
    T = maxp * page
    if max(lens) > min_keys and T >= 2 * min_keys:
        assert n > 1                     # the case does split
    ref = tref.ref_paged_attention(q, kp, vp, bt, ln, softcap=cap)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=TOL, rtol=0)
    jout = _jref_decode(*(jnp.asarray(a) for a in arrs), softcap=cap)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL,
                               rtol=0)
    zero = torch.from_numpy(arrs[4] == 0)
    assert (out[zero] == 0).all()        # exact zeros, not just small


def _dense_mirror(q, k, v, q_start, window, softcap):
    B, Sq, H, hd = q.shape
    n_keys, KV = k.shape[1], k.shape[2]
    G = H // KV
    lo, hi = dense.key_range(n_keys, Sq, q_start, window)
    n, chunk = dense.split_plan(B, KV, lo, hi)
    rows = q.reshape(B, Sq, KV, G, hd).permute(0, 2, 1, 3, 4).reshape(
        B, KV, Sq * G, hd)
    vis = torch.from_numpy(_visible(n_keys, Sq, q_start, window))
    vis = vis.repeat_interleave(G, dim=0)          # row r is query r // G
    out = _mirror(rows, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), vis,
                  torch.full((B,), hi), lo, hi, n, chunk, tref.NEG_INF,
                  softcap)
    out = out.reshape(B, KV, Sq, G, hd).permute(0, 2, 1, 3, 4)
    return out.reshape(B, Sq, H, hd), n


DENSE_CASES = [  # (B, Sq, n_keys, H, KV, hd, q_start, window, softcap)
    (1, 1, 1024, 4, 2, 16, 1023, 0, 0.0),       # decode
    (3, 1, 1024, 4, 2, 16, 1023, 0, 0.0),       # B = 3
    (1, 1, 1024, 4, 2, 16, 1023, 300, 0.0),     # windowed decode
    (1, 1, 2000, 4, 2, 16, 1999, 1000, 0.0),    # window start off the tiles
    (1, 1, 1024, 4, 2, 16, 1500, 300, 0.0),     # past the buffer: uniform
    (1, 1, 1024, 4, 2, 16, 1100, 300, 0.0),     # past the end, sees some
    (2, 1, 1024, 4, 2, 16, 1300, 0, 0.0),       # past the end, no window
    (2, 4, 700, 8, 2, 16, 800, 0, 30.0),        # Sq * G = 16, softcap
    (1, 3, 600, 8, 2, 16, 2000, 40, 0.0),       # every row sees none
    (1, 2, 1030, 4, 2, 16, 1050, 40, 0.0),      # first row sees more
    (1, 1, 768, 2, 2, 16, 767, 0, 0.0),         # MHA, slices end on 768
]


@pytest.mark.parametrize("case", DENSE_CASES, ids=str)
def test_split_mirror_matches_dense_references(case):
    B, Sq, n_keys, H, KV, hd, q_start, window, cap = case
    assert Sq * (H // KV) <= 16          # the decode route's shapes
    g = rng(n_keys + q_start)
    arrs = (normal(g, B, Sq, H, hd), normal(g, B, n_keys, KV, hd),
            normal(g, B, n_keys, KV, hd))
    q, k, v = (torch.from_numpy(a) for a in arrs)
    kw = dict(q_start=q_start, window=window, softcap=cap)
    out, n = _dense_mirror(q, k, v, q_start, window, cap)
    lo, hi = dense.key_range(n_keys, Sq, q_start, window)
    if hi - lo >= 2 * split.MIN_SPLIT_KEYS:
        assert n > 1
    ref = tref.ref_prefill_attention(q, k, v, **kw)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=TOL, rtol=0)
    jout = _jref_dense(*(jnp.asarray(a) for a in arrs), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL,
                               rtol=0)
    if window > 0 and q_start + Sq - window >= n_keys:
        # no key in any row's window: every row is V's plain mean
        mean = v.mean(1).repeat_interleave(H // KV, dim=1)
        np.testing.assert_allclose(out.numpy(),
                                   mean[:, None].expand_as(out).numpy(),
                                   atol=TOL, rtol=0)
