"""The port's optimizer and train step against the JAX package's, on the
same seeded numpy values: ``adamw_update`` over several steps of random
gradients on a random tree (moments within 1e-6 of their scale,
parameters within 1e-6, the gradient norm within 1e-6 relative; the
clip binds on some steps), ``cosine_lr`` at the warmup edge and past the
end (within 1e-7 relative), and three ``train_step``s of reduced archs:
loss, grad norm and lr at each step (f32 within 2e-5; bf16 within 2e-2
relative), both moments within 2e-5 of their scale (f32) and every
parameter within the sum of 2 lr_t over the steps (Adam's first step
moves a parameter by lr times the sign of its gradient, so a gradient at
rounding level can move it the other way). Then the attention ops'
autograd guard on the CPU: every ``kernels.ops`` call raises under
autograd, and the serving forward's kernel route with it.
"""
import numpy as np
import pytest
import torch
from torch_parity import (bridge, fan_in_d, jax_cfg_f32, jax_params_numpy,
                          normal, rng, torch_cfg)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.train import loop as JLOOP  # noqa: E402
from repro.train import optimizer as JOPT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.train import loop as TLOOP  # noqa: E402
from repro_torch.train import optimizer as TOPT  # noqa: E402
from repro_torch.train.data import PackedTokenDataset  # noqa: E402


def _tree(g):
    """A random parameter-shaped tree: dicts and a list, as model_decls."""
    return {"embed": normal(g, 7, 5),
            "stages": [{"b0": {"w": normal(g, 2, 5, 3), "b": normal(g, 2, 3)}},
                       {"b0": {"w": normal(g, 1, 3, 5)}}],
            "final_norm": normal(g, 5)}


def _np_leaves(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


def test_adamw_update_matches_jax_over_steps():
    g = rng(0)
    params = _tree(g)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.from_numpy, params)
    jstate, tstate = JOPT.adamw_init(jp), TOPT.adamw_init(tp)
    assert int(tstate.step) == 0 and tstate.step.dtype == torch.int32
    for step in range(6):
        # gradients of norm ~0.1 to ~20: the clip at 1.0 binds on most
        grads = jax.tree.map(lambda a: a * 10.0 ** (step % 3 - 1),
                             _tree(rng(step + 1)))
        lr = 1e-2 * (step + 1)
        jp, jstate, jn = JOPT.adamw_update(
            jax.tree.map(jnp.asarray, grads), jstate, jp, lr=lr)
        tp, tstate, tn = TOPT.adamw_update(
            jax.tree.map(torch.from_numpy, grads), tstate, tp, lr=lr)
        assert int(tstate.step) == int(jstate.step) == step + 1
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for got, want in ((tp, jp), (tstate.mu, jstate.mu),
                          (tstate.nu, jstate.nu)):
            for a, b in zip(TOPT.leaves(got), _np_leaves(want)):
                np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                           atol=1e-6 * max(1.0,
                                                           np.abs(b).max()))


def test_adamw_update_writes_in_place():
    tp = jax.tree.map(torch.from_numpy, _tree(rng(0)))
    state = TOPT.adamw_init(tp)
    ptrs = [t.data_ptr() for t in TOPT.leaves((tp, state.mu, state.nu))]
    grads = jax.tree.map(torch.from_numpy, _tree(rng(1)))
    out, state2, _ = TOPT.adamw_update(grads, state, tp)
    assert out is tp and state2.mu is state.mu and state2.nu is state.nu
    assert ptrs == [t.data_ptr()
                    for t in TOPT.leaves((out, state2.mu, state2.nu))]


STEPS = [0, 1, 50, 99, 100, 101, 5000, 9999, 10000, 10001, 20000]


def test_cosine_lr_matches_jax():
    for s in STEPS:
        want = float(JOPT.cosine_lr(jnp.asarray(s, jnp.int32)))
        got = TOPT.cosine_lr(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-7)
        np.testing.assert_allclose(float(TOPT.cosine_lr(s, base_lr=1.0)),
                                   float(JOPT.cosine_lr(
                                       jnp.asarray(s, jnp.int32),
                                       base_lr=1.0)), rtol=1e-7)


# ---------------- train_step ------------------------------------------------

BASE_LR, N_STEPS = 1e-2, 3
_JSTEP = jax.jit(JLOOP.train_step, static_argnames=("cfg", "base_lr"))


def _batches(cfg):
    data = PackedTokenDataset(cfg.vocab_size, 16, seed=4)
    out = []
    for step in range(N_STEPS):
        b = data.batch(step, 2)
        if cfg.arch_type == "vlm":
            b["mm_embeds"] = normal(rng(step), 2, 4, cfg.d_model)
        out.append(b)
    return out


@pytest.mark.parametrize("arch,dt", [("chatglm3-6b", "f32"),
                                     ("qwen2-vl-2b", "bf16"),
                                     ("phi3.5-moe-42b-a6.6b", "f32")])
def test_train_steps_match_jax(arch, dt):
    jc, tc = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    if dt == "f32":
        jc, tc = jax_cfg_f32(jc), torch_cfg(tc, torch.float32)
    np_params = fan_in_d(jax_params_numpy(jax_cfg_f32(jc), jitter=0.05),
                         jc.num_heads, jc.d_model)
    jp = jax.tree.map(jnp.asarray, np_params)
    jstate = JLOOP.TrainState(jp, JOPT.adamw_init(jp))
    tp = bridge(np_params, tc)
    tstate = TLOOP.TrainState(tp, TOPT.adamw_init(tp))
    moved = 0.0
    for b in _batches(jc):
        jstate, jm = _JSTEP(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                            jc, base_lr=BASE_LR)
        tstate, tm = TLOOP.train_step(
            tstate, {k: torch.from_numpy(v) for k, v in b.items()}, tc,
            base_lr=BASE_LR)
        for k in ("loss", "aux_loss", "grad_norm", "lr"):
            assert np.isfinite(float(tm[k]))
            if dt == "f32" or k == "lr":
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=2e-5, atol=2e-5, err_msg=k)
            else:
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=2e-2, err_msg=k)
        moved += 2 * float(jm["lr"])
    assert int(tstate.opt.step) == int(jstate.opt.step) == N_STEPS
    for a, b in zip(TOPT.leaves(tstate.params),
                    _np_leaves(jstate.params)):
        assert np.abs(a.numpy() - b).max() <= moved
    if dt == "f32":
        for a, b in zip(TOPT.leaves((tstate.opt.mu, tstate.opt.nu)),
                        _np_leaves((jstate.opt.mu, jstate.opt.nu))):
            assert np.abs(a.numpy() - b).max() <= 2e-5 * np.abs(b).max()
    assert not torch.equal(TOPT.leaves(tstate.params)[0],
                           TOPT.leaves(bridge(np_params, tc))[0])


def test_train_step_state_never_requires_grad():
    tc = torch_cfg(tconfigs.get_reduced("chatglm3-6b"), torch.float32)
    state = TLOOP.make_train_state(tc, torch.Generator().manual_seed(0),
                                   "cpu")
    b = _batches(tc)[0]
    state, m = TLOOP.train_step(state, {k: torch.from_numpy(v)
                                        for k, v in b.items()}, tc)
    assert not any(t.requires_grad for t in TOPT.leaves(state))
    assert not m["loss"].requires_grad


# ---------------- the ops refuse autograd ----------------------------------

def _op_inputs():
    g = rng(9)
    q = torch.from_numpy(normal(g, 2, 4, 4, 16))
    k = torch.from_numpy(normal(g, 2, 6, 2, 16))
    pages = torch.from_numpy(normal(g, 4, 4, 2, 16))
    bt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    lens = torch.tensor([5, 8], dtype=torch.int32)
    return q, k, pages, bt, lens


CALLS = {
    "paged_attention": lambda q, k, pg, bt, ln: kops.paged_attention(
        q[:, 0], pg, pg, bt, ln),
    "paged_prefill_attention": lambda q, k, pg, bt, ln:
        kops.paged_prefill_attention(q, pg, pg, bt, ln * 0, ln // 2),
    "prefill_attention": lambda q, k, pg, bt, ln: kops.prefill_attention(
        q, k, k),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_kernel_ops_refuse_autograd(name):
    q, k, pages, bt, lens = _op_inputs()
    call = CALLS[name]
    want = call(q, k, pages, bt, lens)          # nothing requires grad
    for grad_of in ("q", "kv"):
        qq = q.clone().requires_grad_(grad_of == "q")
        kk = k.clone().requires_grad_(grad_of == "kv")
        pp = pages.clone().requires_grad_(grad_of == "kv")
        with pytest.raises(RuntimeError, match=name):
            call(qq, kk, pp, bt, lens)
        with torch.no_grad():
            assert torch.equal(call(qq, kk, pp, bt, lens), want)


def test_serving_forward_refuses_autograd_but_mha_route_differentiates():
    tc = torch_cfg(tconfigs.get_reduced("chatglm3-6b"), torch.float32)
    params = bridge(jax_params_numpy(jax_cfg_f32(
        jconfigs.get_reduced("chatglm3-6b"))), tc)
    toks = torch.from_numpy(rng(2).integers(1, tc.vocab_size, (1, 8)))
    with torch.no_grad():
        want, _, _ = TT.forward(params, tc, toks)
    params["embed"].requires_grad_()
    with pytest.raises(RuntimeError, match="prefill_attention"):
        TT.forward(params, tc, toks)
    got, _, _ = TT.forward(params, tc, toks, causal_impl="mha")
    torch.testing.assert_close(got.detach(), want, atol=1e-5, rtol=0)
    assert got.requires_grad
