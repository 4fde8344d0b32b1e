"""The prefill kernels' query tiles and their wgmma walk, on the CPU.

The kernels themselves (``csrc/prefill_wgmma.cuh``) run only on the card
(tests/test_torch_kernels_cuda.py and chip_smoke.py); what surrounds them
is held here:

- the host plan (``kernels/tiles.py``): its tiles cover every query of
  the chunk exactly once and hold at most 128 rows each, and the kernels'
  map from a block's rank to its tile launches the longest walk first;
- a torch mirror of the walk: per (sequence, kv head, tile) the block's
  rows r = qi * G + gi in 64-row halves (the two consumer warpgroups),
  128-key tiles from the walk's first key to its end, each key's mask value
  (-inf paged, the finite -1e30 dense), the online softmax in base 2 (the
  kernel folds log2(e) into the scale), and P rounded to bf16 where the
  kernel rounds it. In f32 it must match the plain
  versions (``kernels.ref``) and the JAX oracles within 2e-5, the
  tolerance of tests/test_kernels.py, on G = 1, 2, 6 and 16, chunks just
  over the decode route (Sq * G = 18), chunks ending mid-tile, padding
  rows (exact zeros), windows and a dense row that sees no key (a uniform
  average over every key).
"""
import math

import numpy as np
import pytest
import torch
from torch_parity import normal, rng

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import prefill_attention as dense  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import tiles  # noqa: E402

_jref_paged = jax.jit(jref.ref_paged_prefill_attention,
                      static_argnames="softcap")
_jref_dense = jax.jit(jref.ref_prefill_attention,
                      static_argnames=("q_start", "window", "softcap"))

TOL = 2e-5
KEYS = tiles.KEYS  # keys per K/V tile
HALF_ROWS = 64     # rows per consumer warpgroup
LOG2E = math.log2(math.e)


# ---------------------------------------------------------------------------
# the host plan
# ---------------------------------------------------------------------------

def _queries(Sq, bq, t):
    return range(t * bq, min(Sq, (t + 1) * bq))


@pytest.mark.parametrize("Sq", [1, 2, 7, 8, 9, 21, 64, 100, 128, 129, 512,
                                1536])
@pytest.mark.parametrize("G", [1, 2, 3, 6, 12, 16])
def test_tile_plan_covers_the_chunk_once_longest_walk_first(Sq, G):
    B, KV = 3, 2
    bq, n = tiles.plan(Sq, G)
    assert bq * G <= tiles.ROWS
    # the grid in launch order, through the kernels' rank -> tile map
    grid = [tiles.block_coords(r, n, B, KV) for r in range(n * B * KV)]
    assert sorted(grid) == [(t, b, h) for t in range(n) for b in range(B)
                            for h in range(KV)]        # each block once
    seen = [q for t in range(n) for q in _queries(Sq, bq, t)]
    assert sorted(seen) == list(range(Sq))            # each query once
    # causal: a tile's walk ends at its last query, so launch order is
    # longest walk first
    last = [_queries(Sq, bq, t)[-1] for t, _, _ in grid]
    assert last == sorted(last, reverse=True)
    if Sq >= tiles.ROWS // G:
        assert bq == tiles.ROWS // G                  # full blocks


def test_tile_plan_at_the_serving_shapes():
    assert tiles.plan(512, 6) == (21, 25)      # qwen2-vl: 126 rows
    assert tiles.plan(512, 2) == (64, 8)       # gemma3 chunk
    assert tiles.plan(1536, 2) == (64, 24)     # cache-less
    assert tiles.plan(8, 16) == (8, 1)
    assert tiles.plan(3, 6) == (3, 1)          # 18 rows: one half
    with pytest.raises(ValueError):
        tiles.plan(0, 2)


# ---------------------------------------------------------------------------
# the torch mirror of the walk
# ---------------------------------------------------------------------------

def _walk(q, k, v, ok, vis, k0, k_end, masked, softcap, p_bf16):
    """One block: rows q (R, hd), R <= 128, dead where ``ok`` is False,
    against keys k, v (T, hd) indexed by position; ``vis(keys)`` is (R, n)
    bool. Walks keys k0 .. k_end - 1 in KEYS-key tiles, each 64-row half on
    its own (a consumer warpgroup), as the kernel does."""
    R, hd = q.shape
    T = k.shape[0]
    assert R <= tiles.ROWS
    scale = 1.0 / math.sqrt(hd)
    out = torch.zeros((R, hd))
    for w0 in range(0, R, HALF_ROWS):
        rows = slice(w0, min(R, w0 + HALF_ROWS))
        qw, okw = q[rows], ok[rows]
        n = qw.shape[0]
        m = torch.full((n,), -math.inf)
        l = torch.zeros(n)
        o = torch.zeros((n, hd))
        for t0 in range(k0, k_end, KEYS):
            keys = t0 + torch.arange(KEYS)
            live = keys < k_end
            kc = keys.clamp(max=T - 1)
            s = qw @ k[kc].T * scale
            if softcap > 0:
                s = torch.tanh(s / softcap) * softcap
            s = s * LOG2E          # the kernel's softmax runs in base 2
            s = torch.where(vis(kc)[rows], s, torch.full_like(s, masked))
            s = torch.where(live[None] & okw[:, None], s,
                            torch.full_like(s, -math.inf))
            m_new = torch.maximum(m, s.amax(-1))
            none = m_new == -math.inf
            alpha = torch.where(none, torch.ones_like(m),
                                torch.exp2(m - m_new))
            p = torch.where(none[:, None], torch.zeros_like(s),
                            torch.exp2(s - m_new[:, None]))
            l = l * alpha + p.sum(-1)
            pv = p.to(torch.bfloat16).float() if p_bf16 else p
            vt = torch.where(live[:, None], v[kc], torch.zeros_like(v[kc]))
            o = o * alpha[:, None] + pv @ vt
            m = m_new
        good = okw & (l > 0)
        out[rows] = torch.where(good[:, None], o / l.clamp(min=1e-30)[:, None],
                                torch.zeros_like(o))
    return out


def _rows(x, b, q0, nq, kvh, G):
    """The block's rows r = qi * G + gi of x (B, Sq, H, hd)."""
    return x[b, q0:q0 + nq, kvh * G:(kvh + 1) * G].reshape(nq * G, -1)


def _paged_mirror(q, kp, vp, bt, q_start, new_lens, softcap, p_bf16=False):
    B, Sq, H, hd = q.shape
    _, page, KV, _ = kp.shape
    G, T = H // KV, bt.shape[1] * page
    k = kp[bt.long()].reshape(B, T, KV, hd)
    v = vp[bt.long()].reshape(B, T, KV, hd)
    bq, n = tiles.plan(Sq, G)
    out = torch.full_like(q, float("nan"))
    for rank in range(n * B * KV):        # the grid in launch order
        t, b, kvh = tiles.block_coords(rank, n, B, KV)
        qs, nl = int(q_start[b]), int(new_lens[b])
        q0 = t * bq
        nq = min(bq, Sq - q0)
        qi = torch.arange(nq * G) // G
        last = min(q0 + nq, nl) - 1
        if last < q0:      # a padding tile: zeros, no page read
            out[b, q0:q0 + nq, kvh * G:(kvh + 1) * G] = 0.0
            continue
        kv_end = min(qs + nl, qs + last + 1, T)
        qpos = qs + q0 + qi
        o = _walk(_rows(q, b, q0, nq, kvh, G), k[b, :, kvh], v[b, :, kvh],
                  q0 + qi < nl, lambda keys: keys[None] <= qpos[:, None], 0,
                  kv_end, -math.inf, softcap, p_bf16)
        out[b, q0:q0 + nq, kvh * G:(kvh + 1) * G] = o.reshape(nq, G, hd)
    assert not torch.isnan(out).any()     # every output written once
    return out


def _paged_case(q_start, new_lens, Sq, H, KV, hd, page, seed):
    g = rng(seed)
    B = len(q_start)
    total = max(s + n for s, n in zip(q_start, new_lens))
    maxp = max(1, -(-total // page))
    P = B * maxp + 2
    q = normal(g, B, Sq, H, hd)
    kp, vp = normal(g, P, page, KV, hd), normal(g, P, page, KV, hd)
    bt = g.permutation(P)[:B * maxp].reshape(B, maxp).astype(np.int32)
    return (q, kp, vp, bt, np.asarray(q_start, np.int32),
            np.asarray(new_lens, np.int32))


PAGED_CASES = [  # (q_start, new_lens, Sq, H, KV, hd, page, softcap)
    ([0, 70], [40, 33], 40, 2, 2, 16, 16, 0.0),         # G = 1
    ([5, 0, 130], [100, 7, 90], 100, 4, 2, 16, 16, 0.0),  # G = 2, mid-tile
    ([0, 200, 31], [50, 22, 0], 50, 12, 2, 16, 16, 0.0),  # G = 6, dead rows
    ([3, 64], [20, 9], 20, 16, 1, 16, 4, 30.0),         # G = 16, softcap
    ([17, 0], [9, 9], 9, 4, 2, 16, 48, 0.0),            # Sq * G = 18
    ([0, 1024, 584, 0], [64, 30, 64, 0], 64, 12, 2, 16, 16, 0.0),  # qwen2-vl
]


@pytest.mark.parametrize("case", PAGED_CASES, ids=str)
def test_walk_mirror_matches_paged_references(case):
    qs, nl, Sq, H, KV, hd, page, cap = case
    arrs = _paged_case(qs, nl, Sq, H, KV, hd, page, seed=Sq + H)
    q, kp, vp, bt, q_start, new_lens = (torch.from_numpy(a) for a in arrs)
    out = _paged_mirror(q, kp, vp, bt, q_start, new_lens, cap)
    ref = tref.ref_paged_prefill_attention(q, kp, vp, bt, q_start, new_lens,
                                           softcap=cap)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=TOL, rtol=0)
    jout = _jref_paged(*(jnp.asarray(a) for a in arrs), softcap=cap)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL,
                               rtol=0)
    pad = torch.arange(Sq)[None, :] >= new_lens.long()[:, None]
    assert (out[pad] == 0).all()          # exact zeros, not just small


def _dense_mirror(q, k, v, q_start, window, softcap, p_bf16=False):
    B, Sq, H, hd = q.shape
    n_keys, KV = k.shape[1], k.shape[2]
    G = H // KV
    bq, n = tiles.plan(Sq, G)
    out = torch.full_like(q, float("nan"))
    for rank in range(n * B * KV):        # the grid in launch order
        t, b, kvh = tiles.block_coords(rank, n, B, KV)
        q0 = t * bq
        nq = min(bq, Sq - q0)
        lo, hi = dense.key_range(n_keys, nq, q_start + q0, window)
        qpos = q_start + q0 + torch.arange(nq * G) // G

        def vis(keys):
            m = keys[None] <= qpos[:, None]
            if window > 0:
                m = m & (keys[None] > qpos[:, None] - window)
            return m
        o = _walk(_rows(q, b, q0, nq, kvh, G), k[b, :, kvh], v[b, :, kvh],
                  torch.ones(nq * G, dtype=torch.bool), vis, lo, hi,
                  tref.NEG_INF, softcap, p_bf16)
        out[b, q0:q0 + nq, kvh * G:(kvh + 1) * G] = o.reshape(nq, G, hd)
    assert not torch.isnan(out).any()
    return out


DENSE_CASES = [  # (B, Sq, n_keys, H, KV, hd, q_start, window, softcap)
    (1, 40, 100, 2, 2, 16, 60, 0, 0.0),       # G = 1, slot-buffer prefix
    (2, 100, 150, 4, 2, 16, 50, 0, 0.0),      # G = 2, chunk ends mid-tile
    (1, 45, 45, 12, 2, 16, 0, 0, 0.0),        # G = 6 cache-less, dead rows
    (1, 20, 300, 16, 1, 16, 280, 0, 30.0),    # G = 16, softcap
    (1, 9, 200, 4, 2, 16, 150, 0, 0.0),       # Sq * G = 18
    (1, 130, 400, 4, 2, 16, 270, 70, 0.0),    # window: walks start late
    (1, 30, 90, 4, 2, 16, 200, 40, 0.0),      # no row sees a key: uniform
    (1, 6, 50, 12, 2, 16, 1980, 2000, 0.0),   # some rows see none
]


@pytest.mark.parametrize("case", DENSE_CASES, ids=str)
def test_walk_mirror_matches_dense_references(case):
    B, Sq, n_keys, H, KV, hd, q_start, window, cap = case
    assert Sq * (H // KV) > 16           # the chunk route's shapes
    g = rng(n_keys + Sq)
    arrs = (normal(g, B, Sq, H, hd), normal(g, B, n_keys, KV, hd),
            normal(g, B, n_keys, KV, hd))
    q, k, v = (torch.from_numpy(a) for a in arrs)
    kw = dict(q_start=q_start, window=window, softcap=cap)
    out = _dense_mirror(q, k, v, q_start, window, cap)
    ref = tref.ref_prefill_attention(q, k, v, **kw)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=TOL, rtol=0)
    jout = _jref_dense(*(jnp.asarray(a) for a in arrs), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL,
                               rtol=0)
    if window > 0 and q_start - window + 1 >= n_keys:
        # no key in any row's window: every row is V's plain mean
        mean = v.mean(1).repeat_interleave(H // KV, dim=1)
        np.testing.assert_allclose(out.numpy(),
                                   mean[:, None].expand_as(out).numpy(),
                                   atol=TOL, rtol=0)


def _rel_rms(out, ref):
    d = (out - ref).flatten(-2).square().mean(-1).sqrt()
    r = ref.flatten(-2).square().mean(-1).sqrt()
    live = r > 0
    return (d[live] / r[live]).max().item()


def test_walk_mirror_with_bf16_p_stays_inside_the_card_gate():
    """With P rounded to bf16 before the PV product, as the kernel rounds
    it, the walk stays within the 1e-2 per-token relative rms limit that
    the card's tests and chip_smoke.py hold the kernels to (a few 1e-3),
    at a qwen2-vl-like chunk over 600 keys and a gemma3-like window."""
    arrs = _paged_case([500, 0], [64, 40], 64, 12, 2, 64, 16, seed=9)
    q, kp, vp, bt, q_start, new_lens = (torch.from_numpy(a) for a in arrs)
    ref = tref.ref_paged_prefill_attention(q, kp, vp, bt, q_start, new_lens)
    out = _paged_mirror(q, kp, vp, bt, q_start, new_lens, 0.0, p_bf16=True)
    assert 1e-4 < _rel_rms(out, ref) < 5e-3
    g = rng(3)
    q, k, v = (torch.from_numpy(normal(g, 1, n, H, 64))
               for n, H in ((100, 8), (700, 4), (700, 4)))
    ref = tref.ref_prefill_attention(q, k, v, q_start=600, window=256)
    out = _dense_mirror(q, k, v, 600, 256, 0.0, p_bf16=True)
    assert 1e-4 < _rel_rms(out, ref) < 5e-3
