"""The port's model against the JAX package's, with the JAX weights carried
over by ``from_jax_numpy``: parameter declarations for every arch, rotary
embeddings, and the paged-cache ``forward`` over one ragged chunked prefill
and one decode step for reduced qwen2-vl-2b (M-RoPE) and chatglm3-6b (half
RoPE). Logits within 1e-4 in f32 and 5e-2 (absolute plus relative) in bf16,
where the two frameworks round at different points."""
import numpy as np
import pytest
import torch
from torch_parity import (bridge, jax_cfg_f32, jax_params_numpy, normal, rng,
                          torch_cfg)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.cache.paged import PagedStackStore as JStore  # noqa: E402
from repro.models import rope as jrope  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import param_count as jcount  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.cache.paged import PagedStackStore as TStore  # noqa: E402
from repro_torch.models import rope as trope  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.params import (from_jax_numpy,  # noqa: E402
                                       init_params, param_count,
                                       tree_leaves)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_decls_match_jax_for_every_arch(arch):
    """Same config values and the same declaration tree, leaf for leaf,
    for the full and the reduced config of all ten archs."""
    for get in ("get_config", "get_reduced"):
        jc = getattr(jconfigs, get)(arch)
        tc = getattr(tconfigs, get)(arch)
        assert {k: v for k, v in vars(jc).items() if k != "dtype"} == \
            {k: v for k, v in vars(tc).items() if k != "dtype"}
        assert tc.dtype == torch.bfloat16
        jd = jax.tree.leaves(JT.model_decls(jc),
                             is_leaf=lambda x: hasattr(x, "axes"))
        td = tree_leaves(TT.model_decls(tc))
        assert [(d.shape, d.axes, d.init, d.scale) for d in jd] == \
            [(d.shape, d.axes, d.init, d.scale) for d in td]
        assert jcount(JT.model_decls(jc)) == param_count(TT.model_decls(tc))
        assert JT.paged_supported(jc) == TT.paged_supported(tc)
        assert jc.stages() == tc.stages()


def test_weight_bridge_checks_every_path():
    jc = jconfigs.get_reduced("chatglm3-6b")
    tree = jax_params_numpy(jc)
    decls = TT.model_decls(tconfigs.get_reduced("chatglm3-6b"))
    got = from_jax_numpy(tree, decls)
    np.testing.assert_array_equal(got["stages"][0]["b0"]["attn"]["wq"],
                                  tree["stages"][0]["b0"]["attn"]["wq"])
    bad = dict(tree, embed=tree["embed"][:, :8])
    with pytest.raises(ValueError, match="params.embed"):
        from_jax_numpy(bad, decls)
    with pytest.raises(KeyError, match="params"):
        from_jax_numpy(dict(tree, extra=tree["embed"]), decls)


def test_init_params_is_seeded():
    decls = TT.model_decls(tconfigs.get_reduced("qwen2-vl-2b"))
    a = init_params(decls, torch.Generator().manual_seed(3))
    b = init_params(decls, torch.Generator().manual_seed(3))
    for x, y in zip(tree_leaves(a, torch.is_tensor),
                    tree_leaves(b, torch.is_tensor)):
        assert torch.equal(x, y)
    assert not torch.equal(a["embed"], init_params(
        decls, torch.Generator().manual_seed(4))["embed"])


@pytest.mark.parametrize("style", ["llama", "half", "mrope", "none"])
def test_rope_matches_jax(style):
    g = rng(1)
    x = normal(g, 2, 5, 3, 16)
    pos = g.integers(0, 300, (2, 5)).astype(np.int32)
    pos3 = g.integers(0, 300, (2, 5, 3)).astype(np.int32)
    for p in (pos, pos3) if style == "mrope" else (pos,):
        ref = jrope.apply_rope(jnp.asarray(x), jnp.asarray(p), 1e6, style)
        out = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(p), 1e6,
                               style)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


# ---------------- paged forward: prefill chunk + decode step ---------------

PAGE, PPL = 4, 20
BT = np.array([[0, 1, 2, 3, 4, PPL - 1, PPL - 1, PPL - 1],
               [5, 6, 7, 8, PPL - 1, PPL - 1, PPL - 1, PPL - 1]], np.int32)


def _jax_forward(jc, jp, stores, toks, pos, lengths, new_lens):
    cache = {"stages": stores, "block_table": jnp.asarray(BT),
             "lengths": jnp.asarray(lengths), "new_lens": jnp.asarray(new_lens)}
    lg, nc, _ = JT.forward(jp, jc, jnp.asarray(toks),
                           positions=jnp.asarray(pos), cache=cache,
                           last_pos=jnp.asarray(np.maximum(new_lens - 1, 0)))
    return np.asarray(lg.astype(jnp.float32)), nc["stages"]


def _torch_forward(tc, tp, stores, toks, pos, lengths, new_lens, impl):
    cache = {"stages": stores, "block_table": torch.from_numpy(BT),
             "lengths": torch.from_numpy(lengths),
             "new_lens": torch.from_numpy(new_lens)}
    lg, _, _ = TT.forward(tp, tc, torch.from_numpy(toks),
                          positions=torch.from_numpy(pos), cache=cache,
                          last_pos=torch.from_numpy(
                              np.maximum(new_lens - 1, 0)),
                          attn_impl=impl)
    return lg.float().numpy()


_JAX_LOGITS = {}


def _jax_run(arch, dt):
    """JAX logits for (prefill, decode), computed once per (arch, dtype)."""
    key = (arch, dt)
    if key not in _JAX_LOGITS:
        jc = jconfigs.get_reduced(arch)
        if dt == "f32":
            jc = jax_cfg_f32(jc)
        # f32 masters either way (the forward casts to cfg.dtype)
        jp = jax.tree.map(jnp.asarray,
                          jax_params_numpy(jax_cfg_f32(jc), jitter=0.05))
        stores = [{f"b{i}": JStore.build(r, PPL, PAGE, jc.num_kv_heads,
                                         jc.hd) for i, _ in enumerate(p)}
                  for p, r in jc.stages()]
        out = []
        for toks, pos, lengths, new_lens in _steps(jc.vocab_size):
            lg, stores = _jax_forward(jc, jp, stores, toks, pos, lengths,
                                      new_lens)
            out.append(lg)
        _JAX_LOGITS[key] = out
    return _JAX_LOGITS[key]


def _steps(vocab):
    """A ragged prefill chunk (8 and 5 real tokens) then one decode."""
    g = rng(2)
    toks = g.integers(1, vocab, (2, 8)).astype(np.int32)
    pos = np.tile(np.arange(8, dtype=np.int32), (2, 1))
    yield toks, pos, np.zeros(2, np.int32), np.array([8, 5], np.int32)
    tok = g.integers(1, vocab, (2, 1)).astype(np.int32)
    yield tok, np.array([[8], [5]], np.int32), np.array([8, 5], np.int32), \
        np.ones(2, np.int32)


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "chatglm3-6b",
                                  "phi3.5-moe-42b-a6.6b", "grok-1-314b"])
def test_paged_forward_matches_jax(arch, dt, impl):
    ref = _jax_run(arch, dt)
    jc = jconfigs.get_reduced(arch)
    tc = torch_cfg(tconfigs.get_reduced(arch),
                   torch.float32 if dt == "f32" else torch.bfloat16)
    tp = TT.cast_params(bridge(jax_params_numpy(jax_cfg_f32(jc),
                                                jitter=0.05), tc), tc.dtype)
    stores = [{f"b{i}": TStore.build(r, PPL, PAGE, tc.num_kv_heads, tc.hd)
               for i, _ in enumerate(p)} for p, r in tc.stages()]
    for want, step in zip(ref, _steps(tc.vocab_size)):
        got = _torch_forward(tc, tp, stores, *step, impl)
        assert got.shape == want.shape == (2, 1, tc.vocab_size)
        assert np.isfinite(got).all()
        if dt == "f32":
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        else:
            np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)


def test_forward_refuses_what_is_not_ported():
    """Every family runs without a cache and on the dense cache; the
    paged forward still refuses the archs outside the paged protocol
    (recurrent state, cross attention, sliding window)."""
    for arch in ("xlstm-125m", "phi3.5-moe-42b-a6.6b", "whisper-base",
                 "jamba-1.5-large-398b", "qwen2-vl-2b"):
        tc = tconfigs.get_reduced(arch)
        tp = init_params(TT.model_decls(tc), torch.Generator().manual_seed(0))
        kw = {}
        if tc.is_encoder_decoder:
            kw["enc_frames"] = torch.zeros((1, tc.encoder_seq, tc.d_model))
        lg, cache, aux = TT.forward(tp, tc, torch.zeros((1, 4),
                                                        dtype=torch.int32),
                                    **kw)
        assert lg.shape == (1, 4, tc.vocab_size) and cache is None
        assert torch.isfinite(lg.float()).all()
        assert (aux > 0) == bool(tc.num_experts)     # the MoE balance loss
    for arch in ("xlstm-125m", "whisper-base", "jamba-1.5-large-398b",
                 "gemma3-27b"):
        tc = tconfigs.get_reduced(arch)
        assert not TT.paged_supported(tc) and TT.dense_supported(tc)
        tp = init_params(TT.model_decls(tc), torch.Generator().manual_seed(0))
        cache = {"stages": [], "block_table": torch.zeros((1, 1),
                                                          dtype=torch.int32),
                 "lengths": torch.zeros(1, dtype=torch.int32),
                 "new_lens": torch.ones(1, dtype=torch.int32)}
        with pytest.raises(NotImplementedError, match="paged protocol"):
            TT.forward(tp, tc, torch.zeros((1, 1), dtype=torch.int32),
                       cache=cache)


def test_stacked_leaves_drawn_layer_by_layer():
    """A stacked leaf (first axis "layers") is drawn one layer at a time
    into its preallocated leaf: the declared shape and dtype, the declared
    scale in every layer, different draws per layer, and the same weights
    for the same seed. An unstacked leaf is one draw."""
    from repro_torch.models import params as P
    decls = {"w": P.decl((3, 64, 512), ("layers", "embed", "mlp")),
             "r": P.decl((4, 256, 8), ("layers", "embed", None), scale=0.02),
             "e": P.decl((100, 64), ("vocab", "embed"), scale=0.5)}
    a = init_params(decls, torch.Generator().manual_seed(5),
                    dtype=torch.bfloat16)
    b = init_params(decls, torch.Generator().manual_seed(5),
                    dtype=torch.bfloat16)
    for k, d in decls.items():
        assert a[k].shape == d.shape and a[k].dtype == torch.bfloat16
        assert torch.equal(a[k], b[k])
    for k, std in (("w", 1 / 8), ("r", 0.02)):
        for li in range(decls[k].shape[0]):
            got = a[k][li].float().std().item()
            assert abs(got - std) < 0.05 * std, (k, li, got)
        assert not torch.equal(a[k][0], a[k][1])
    assert abs(a["e"].float().std().item() - 0.5) < 0.05 * 0.5
    c = init_params(decls, torch.Generator().manual_seed(6),
                    dtype=torch.bfloat16)
    assert not torch.equal(a["w"], c["w"])
    # leaves in key order: e as one draw, then r layer by layer
    g = torch.Generator().manual_seed(5)
    e = torch.randn((100, 64), generator=g) * 0.5
    assert torch.equal(a["e"], e.to(torch.bfloat16))
    torch.randn((256, 8), generator=g)                # r[0]
    r1 = torch.randn((256, 8), generator=g) * 0.02
    assert torch.equal(a["r"][1], r1.to(torch.bfloat16))
