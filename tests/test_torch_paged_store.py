"""The port's ``PagedStackStore`` against the JAX package's: the same random
ragged batches (padding tokens, padding rows, clamped over-long rows)
written through ``write_batch`` must leave bit-identical page contents
(values are rounded through bf16 on both sides; the CPU containers are
f32), and ``copy_page``/``gather_batch``/``layer_table`` must agree."""
import numpy as np
import pytest
import torch
from torch_parity import normal, rng

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.cache.paged import PagedStackStore as JStore  # noqa: E402
from repro_torch.cache.paged import PagedStackStore as TStore  # noqa: E402
from repro_torch.cache.paged import store_dtype  # noqa: E402

LAYERS, PPL, PAGE, KV, HD = 3, 10, 4, 2, 16


def _pair():
    j = JStore.build(LAYERS, PPL, PAGE, KV, HD)
    t = TStore.build(LAYERS, PPL, PAGE, KV, HD)
    assert t.k_pages.dtype == torch.float32 == store_dtype("cpu")
    return j, t


def _live(a) -> np.ndarray:
    """Every page except each layer's trash page (padding writes collide
    there in an unspecified order)."""
    a = np.asarray(a).reshape(LAYERS, PPL, PAGE, KV, HD)
    return a[:, :-1]


def _batch(g, B, S):
    k = normal(g, B, S, KV, HD) * 3
    v = normal(g, B, S, KV, HD) * 3
    maxp = 4
    bt = np.full((B, maxp), PPL - 1, np.int32)
    pages = g.permutation(PPL - 1)
    for b in range(B):     # disjoint live pages per row
        bt[b, :2] = pages[2 * b: 2 * b + 2]
    start = g.integers(0, 6, B).astype(np.int32)
    new_lens = g.integers(0, S + 1, B).astype(np.int32)
    new_lens[-1] = 0       # a whole padding row
    return k, v, bt, start, new_lens


def _write(j, t, k, v, bt, start, new_lens, layer):
    j = j.write_batch(jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
                      jnp.asarray(start), jnp.asarray(new_lens), layer=layer)
    t2 = t.write_batch(torch.from_numpy(k), torch.from_numpy(v),
                       torch.from_numpy(bt), torch.from_numpy(start),
                       torch.from_numpy(new_lens), layer=layer)
    assert t2 is t       # in place
    return j, t


@pytest.mark.parametrize("seed", range(6))
def test_write_batch_bit_identical(seed):
    g = rng(seed)
    j, t = _pair()
    for step in range(3):
        k, v, bt, start, new_lens = _batch(g, B=4, S=3)
        j, t = _write(j, t, k, v, bt, start, new_lens, layer=step % LAYERS)
    np.testing.assert_array_equal(_live(j.k_pages), _live(t.k_pages))
    np.testing.assert_array_equal(_live(j.v_pages), _live(t.v_pages))
    # values really were rounded through bf16
    kt = t.k_pages.numpy()
    np.testing.assert_array_equal(
        kt, torch.from_numpy(kt).to(torch.bfloat16).float().numpy())


def test_positions_clamp_to_the_table_before_lookup():
    """A row running past its table's last slot writes the last slot (the
    JAX clamp), never out of range."""
    g = rng(11)
    j, t = _pair()
    k, v = normal(g, 1, 6, KV, HD), normal(g, 1, 6, KV, HD)
    bt = np.array([[2, 5]], np.int32)          # 8 slots
    start = np.array([5], np.int32)            # writes positions 5..10
    new_lens = np.array([6], np.int32)
    j, t = _write(j, t, k, v, bt, start, new_lens, layer=1)
    np.testing.assert_array_equal(_live(j.k_pages), _live(t.k_pages))


def test_copy_page_gather_and_layer_table():
    g = rng(5)
    j, t = _pair()
    k, v, bt, start, new_lens = _batch(g, B=3, S=4)
    new_lens[:] = 4
    for layer in range(LAYERS):
        j, t = _write(j, t, k, v, bt, start, new_lens, layer=layer)
    src, dst = int(bt[0, 0]), int(bt[1, 1])
    j = j.copy_page(jnp.int32(src), jnp.int32(dst))
    assert t.copy_page(src, dst) is t
    np.testing.assert_array_equal(_live(j.k_pages), _live(t.k_pages))
    np.testing.assert_array_equal(_live(j.v_pages), _live(t.v_pages))
    for layer in range(LAYERS):
        jk, jv = j.gather_batch(jnp.asarray(bt), layer=layer)
        tk, tv = t.gather_batch(torch.from_numpy(bt), layer=layer)
        live = bt != PPL - 1
        np.testing.assert_array_equal(
            np.asarray(jk).reshape(3, 4, PAGE, KV, HD)[live],
            tk.numpy().reshape(3, 4, PAGE, KV, HD)[live])
        np.testing.assert_array_equal(
            np.asarray(jv).reshape(3, 4, PAGE, KV, HD)[live],
            tv.numpy().reshape(3, 4, PAGE, KV, HD)[live])
        np.testing.assert_array_equal(
            np.asarray(j.layer_table(jnp.asarray(bt), layer)),
            t.layer_table(torch.from_numpy(bt), layer).numpy())
    assert (t.pages_per_layer, t.page_size, t.trash_page) == \
        (j.pages_per_layer, j.page_size, j.trash_page)


def test_pool_starts_zeroed():
    t = TStore.build(2, 5, 4, 2, 8)
    assert not t.k_pages.any() and not t.v_pages.any()


# -- page-chain migration payloads, the single-layer and slot stores ---------

def _written(seed=3):
    """A JAX and a port store holding the same random ragged writes on
    every layer."""
    g = rng(seed)
    j, t = _pair()
    for layer in range(LAYERS):
        k, v, bt, start, new_lens = _batch(g, B=3, S=4)
        j, t = _write(j, t, k, v, bt, start, new_lens, layer=layer)
    return j, t


def test_export_import_round_trip_is_bit_exact():
    _, t = _written()
    dst = TStore.build(LAYERS, PPL, PAGE, KV, HD)
    for src_page, dst_page in ((0, 4), (3, 3), (8, 0)):
        k, v = t.export_page(src_page)
        assert k.shape == (LAYERS, PAGE, KV, HD) and k.dtype == np.float32
        assert dst.import_page(dst_page, k, v) is dst       # in place
        k2, v2 = dst.export_page(dst_page)
        assert k2.tobytes() == k.tobytes() and v2.tobytes() == v.tobytes()
        rows = torch.arange(LAYERS) * PPL
        assert torch.equal(dst.k_pages[rows + dst_page],
                           t.k_pages[rows + src_page])
        assert torch.equal(dst.v_pages[rows + dst_page],
                           t.v_pages[rows + src_page])


def test_export_page_bytes_match_jax():
    """The same K/V written through ``write_batch`` into a JAX and a port
    store: every live page exports the same bytes (f32 containers on the
    CPU, so the same layout and size)."""
    j, t = _written(seed=4)
    for page in range(PPL - 1):
        jk, jv = j.export_page(page)
        tk, tv = t.export_page(page)
        assert tk.tobytes() == jk.tobytes() and tv.tobytes() == jv.tobytes()


def _executor(**kw):
    from repro_torch.configs import get_reduced
    from repro_torch.serving.executors import ExecutorConfig, ModelExecutor
    return ModelExecutor(get_reduced("chatglm3-6b"),
                         ExecutorConfig(max_slots=2, max_len=64, **kw),
                         device="cpu")


def test_capacity_pages_is_the_bound_allocators():
    from repro_torch.cache import BlockAllocator
    ex = _executor(num_pages=12)
    assert ex.capacity_pages == ex.allocator.num_pages == 12
    ex.bind_allocator(BlockAllocator(num_pages=30, page_size=16))
    assert ex.capacity_pages == 30


def test_page_payload_round_trip_and_length_check():
    """``export_page_payload`` -> ``import_page_payload`` at other page ids
    restores every stage/block store's bytes; a blob of any other length,
    or a count mismatch, raises instead of importing part of it."""
    ex = _executor(num_pages=8)
    g = torch.Generator().manual_seed(0)
    for stage in ex.stores:
        for s in stage.values():
            for a in (s.k_pages, s.v_pages):
                a.copy_(torch.randn(a.shape, generator=g)
                        .to(torch.bfloat16).float())
    blobs = ex.export_page_payload([1, 5])
    cfg = ex.cfg
    per_page = 2 * cfg.num_layers * 16 * cfg.num_kv_heads * cfg.hd * 4
    assert [len(b) for b in blobs] == [per_page] * 2
    ex.import_page_payload([6, 0], blobs)
    assert ex.export_page_payload([6, 0]) == blobs
    for bad in (blobs[0][:-4], blobs[0] + b"\0\0\0\0"):
        with pytest.raises(ValueError, match="page payload"):
            ex.import_page_payload([2], [bad])
    with pytest.raises(ValueError, match="payloads"):
        ex.import_page_payload([2, 3], blobs[:1])
