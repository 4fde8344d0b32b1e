"""The port's training loss and per-leaf gradients against the JAX
package's, on the same seeded numpy weights and batch: ``loss_fn``'s
loss, aux and the gradient of every f32 master leaf against
``jax.value_and_grad`` of the reference's ``loss_fn``, for one reduced
arch of each family (chatglm3: half RoPE and qkv bias; qwen2-vl: stub
patch embeddings, M-RoPE positions and a loss mask; gemma3: sliding
window and softcap; phi3.5-moe: the MoE aux loss; jamba: Mamba and MoE;
xlstm; whisper: encoder frames). Attention q/k/v projections are at
fan-in D (``torch_parity.fan_in_d``), as the forward tests run them.

f32 (``cfg.dtype`` float32 on both sides): loss and aux within 2e-5,
each leaf's gradient within 2e-5 of its own largest element (the two
frameworks' f32 sums differ in their last bits; measured: under 3e-6).

bf16 (the default compute dtype; f32 masters on both sides): loss and aux
as ``torch_parity.close`` holds bf16 values (2e-2 of scale). The
gradients are held to the JAX f32 gradients, no further from them than
the JAX bf16 gradients are: over the leaves, the rms of each leaf's
relative rms error at most 1.1 x the reference's, and the worst leaf's
largest error, relative to that leaf's largest element, at most 1.1 x
the reference's worst plus one bf16 ulp (2**-7). A per-leaf 2e-2 between
the two bf16 runs does not hold: both sit 1-5e-2 from the f32 gradient on
the noisiest leaves (the attention k bias, whose gradient nearly cancels
over the keys; jamba's Mamba and MoE leaves), and they part from each
other by as much. For the MoE families the two bf16 forwards route every
token alike but at near-ties: where the port's ``moe_route`` picks other
experts from the port's MoE input than from the JAX package's, the gap
between the last chosen and the first unchosen gate is under 2**-8 (on
reduced phi3.5-moe one token of its second layer parts so: the two
residual streams differ there by a bf16 ulp or two).
"""
import numpy as np
import pytest
import torch
from torch_parity import (bridge, close, fan_in_d, jax_cfg_f32,
                          jax_params_numpy, normal, rng, torch_cfg)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import loop as JLOOP  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.train import loop as TLOOP  # noqa: E402
from repro_torch.train.optimizer import leaves  # noqa: E402

FAMILIES = ["chatglm3-6b", "qwen2-vl-2b", "gemma3-27b",
            "phi3.5-moe-42b-a6.6b", "jamba-1.5-large-398b", "xlstm-125m",
            "whisper-base"]
MOE = ["phi3.5-moe-42b-a6.6b", "jamba-1.5-large-398b"]
B, S, N_MM = 2, 16, 4
BF16_ULP = 2.0 ** -7


def batch_for(cfg, seed=3):
    """Tokens and next-token labels; for the VLM 4 stub patch embeddings
    on a 2x2 grid with M-RoPE positions (temporal 0, row, column; text
    after them at 2, 3, ... on all three streams) and a loss mask over the
    text; for whisper stub encoder frames. numpy arrays."""
    g = rng(seed)
    toks = g.integers(1, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.arch_type == "vlm":
        batch["mm_embeds"] = normal(g, B, N_MM, cfg.d_model)
        pos = np.zeros((S, 3), np.int32)
        pos[:N_MM, 1] = np.arange(N_MM) // 2
        pos[:N_MM, 2] = np.arange(N_MM) % 2
        pos[N_MM:] = (2 + np.arange(S - N_MM))[:, None]
        batch["positions"] = np.broadcast_to(pos, (B, S, 3)).copy()
        mask = np.ones((B, S), np.float32)
        mask[:, :N_MM - 1] = 0.0
        batch["loss_mask"] = mask
    if cfg.is_encoder_decoder:
        batch["enc_frames"] = normal(g, B, cfg.encoder_seq, cfg.d_model)
    return batch


def weights(arch):
    jc = jax_cfg_f32(jconfigs.get_reduced(arch))
    np_params = jax_params_numpy(jc, jitter=0.05)
    return fan_in_d(np_params, jc.num_heads, jc.d_model)


_JGRAD = jax.jit(jax.value_and_grad(JLOOP.loss_fn, has_aux=True),
                 static_argnames=("cfg", "remat"))
_JAX = {}


def jax_side(arch, dt):
    """(loss, aux, [grad leaves]) of the reference, numpy, cached."""
    if (arch, dt) not in _JAX:
        jc = jconfigs.get_reduced(arch)
        if dt == "f32":
            jc = jax_cfg_f32(jc)
        jp = jax.tree.map(jnp.asarray, weights(arch))
        jb = {k: jnp.asarray(v) for k, v in batch_for(jc).items()}
        (_, (loss, aux)), grads = _JGRAD(jp, jc, jb)
        _JAX[arch, dt] = (float(loss), float(aux),
                          [np.asarray(g) for g in jax.tree.leaves(grads)])
    return _JAX[arch, dt]


def port_side(arch, dt, remat=False):
    """(loss, aux, [grad leaves]) of the port's ``loss_fn`` from f32
    masters, in ``tree_leaves`` order (the order ``jax.tree`` gives)."""
    tc = tconfigs.get_reduced(arch)
    if dt == "f32":
        tc = torch_cfg(tc, torch.float32)
    params = bridge(weights(arch), tc)
    live = [p.requires_grad_() for p in leaves(params)]
    batch = {k: torch.from_numpy(v) for k, v in batch_for(tc).items()}
    total, (loss, aux) = TLOOP.loss_fn(params, tc, batch, remat=remat)
    grads = torch.autograd.grad(total, live)
    return float(loss), float(aux), [g.numpy() for g in grads]


def _rel(err, ref, how):
    if how == "max":
        return np.abs(err).max() / np.abs(ref).max()
    return np.sqrt(np.mean(err * err)) / np.sqrt(np.mean(ref * ref))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch, dt):
    got_loss, got_aux, got = port_side(arch, dt)
    want_loss, want_aux, want = jax_side(arch, dt)
    assert len(got) == len(want)
    assert all(g.shape == w.shape for g, w in zip(got, want))
    assert all(np.isfinite(g).all() for g in got)
    if dt == "f32":
        assert abs(got_loss - want_loss) <= 2e-5
        assert abs(got_aux - want_aux) <= 2e-5
        for i, (g, w) in enumerate(zip(got, want)):
            assert np.abs(g - w).max() <= 2e-5 * np.abs(w).max(), i
        return
    close(torch.tensor([got_loss, got_aux]),
          np.array([want_loss, want_aux]), "bf16", "loss, aux")
    truth = jax_side(arch, "f32")[2]
    stats = {}
    for side, grads in (("port", got), ("jax", want)):
        rms = [_rel(g - t, t, "rms") for g, t in zip(grads, truth)]
        stats[side] = (np.sqrt(np.mean(np.square(rms))),
                       max(_rel(g - t, t, "max")
                           for g, t in zip(grads, truth)))
    (port_rms, port_max), (jax_rms, jax_max) = stats["port"], stats["jax"]
    assert port_rms <= 1.1 * jax_rms, stats
    assert port_max <= 1.1 * jax_max + BF16_ULP, stats


@pytest.mark.parametrize("arch", ["chatglm3-6b", "phi3.5-moe-42b-a6.6b",
                                  "whisper-base"])
def test_remat_gives_the_same_loss_and_grads(arch):
    """Recomputing each block in the backward (MoE routing included)
    changes nothing: the same loss, aux and gradients, bit for bit."""
    plain, remat = port_side(arch, "bf16"), port_side(arch, "bf16", True)
    assert plain[:2] == remat[:2]
    for g, r in zip(plain[2], remat[2]):
        np.testing.assert_array_equal(g, r)


def _moe_inputs(monkeypatch, module, convert):
    """Record the input and router of every ``moe_block`` call made
    through ``module`` (the JAX package's or the port's layers)."""
    seen, orig = [], module.moe_block

    def spy(x, p, cfg, **kw):
        seen.append((convert(x), convert(p["router"])))
        return orig(x, p, cfg, **kw)
    monkeypatch.setattr(module, "moe_block", spy)
    return seen


@pytest.mark.parametrize("arch", MOE)
def test_bf16_routing_parts_from_jax_only_at_near_ties(arch, monkeypatch):
    """The bf16 forwards' MoE inputs, each routed by the port's
    ``moe_route`` (held to the reference's in test_torch_moe.py): the
    top-k experts agree for every token but those whose last chosen and
    first unchosen gates lie within 2**-8."""
    jc, tc = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    np_w, toks = weights(arch), batch_for(jc)["tokens"]
    to_t = lambda a: torch.from_numpy(  # noqa: E731
        np.array(jnp.asarray(a).astype(jnp.float32))).to(torch.bfloat16)
    jseen = _moe_inputs(monkeypatch, JL, to_t)
    with jax.disable_jit():     # concrete values through the layer scan
        JT.forward(jax.tree.map(jnp.asarray, np_w), jc, jnp.asarray(toks))
    tseen = _moe_inputs(monkeypatch, TL, lambda a: a.detach().clone())
    TT.forward(TT.cast_params(bridge(np_w, tc), tc.dtype), tc,
               torch.from_numpy(toks), causal_impl="mha")
    assert len(jseen) == len(tseen) > 0
    K = tc.experts_per_token
    for (xj, router), (xt, _) in zip(jseen, tseen):
        rj, rt = TL.moe_route(xj, router, tc), TL.moe_route(xt, router, tc)
        parted = (rj["topi"] != rt["topi"]).any(-1)
        for r in (rj, rt):
            top = torch.sort(r["gates"], -1, descending=True).values
            gap = top[..., K - 1] - top[..., K]
            assert (gap[parted] < 2.0 ** -8).all()
