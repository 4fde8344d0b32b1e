"""The port's ``moe_block`` against the JAX package's on the same seeded
numpy inputs: a sequence that is not a multiple of the group size (so
several groups per row and a padded last one), one group per row, and a
router forced to one expert, so that capacity drops occur. Output and
aux loss within 2e-5 in f32 and 2e-2 in bf16 (the same bf16 values on
both sides). Then the emitted token streams of the port's
``ModelExecutor`` on the batched paged path against the JAX
``ModelExecutor``'s for reduced phi3.5-moe, in f32: identical."""
import numpy as np
import pytest
import torch
from torch_parity import both, normal, rng

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

ARCH = "phi3.5-moe-42b-a6.6b"
TOL = {"f32": 2e-5, "bf16": 2e-2}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}

# (S, group_size, forced): S = 19 in groups of 8 -> 3 groups a row, the
# last padded by 5; S = 12 in one group; a router that sends every token
# to expert 1 first (S = 16: two full groups a row), so it overflows its
# C slots
CASES = {"ragged": (19, 8, False), "one_group": (12, 512, False),
         "forced": (16, 8, True)}


# jitted, as the JAX package serves it: XLA keeps the router product's f32
# result where an eager call rounds it to bf16
_JMOE = jax.jit(JL.moe_block, static_argnames=("cfg", "group_size"))


def _weights(cfg, forced):
    g = rng(11)
    D, E, F = cfg.d_model, cfg.num_experts, cfg.d_ff
    # router logits of std ~8: top-k margins far above bf16 rounding
    w = {"router": 0.5 * normal(g, D, E),
         "wi": normal(g, E, D, F) / np.sqrt(D),
         "wg": normal(g, E, D, F) / np.sqrt(D),
         "wo": normal(g, E, F, D) / np.sqrt(F)}
    if forced:   # with inputs of mean 0.5 (see _inputs): logit 1 ~ +64
        w["router"][:, 1] += 0.5
    return w


def _inputs(cfg, S, forced, seed=12):
    """Unit normal inputs; for the forced router, of mean 0.5 and mean
    square 0.5."""
    x = normal(rng(seed), 2, S, cfg.d_model)
    return 0.5 * x + 0.5 if forced else x


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_block_matches_jax(case, dt):
    S, group, forced = CASES[case]
    jc, tc = jconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)
    jw, tw = {}, {}
    for k, a in _weights(jc, forced).items():
        jw[k], tw[k] = both(a, dt)
    jx, tx = both(_inputs(jc, S, forced), dt)
    want, jaux = _JMOE(jx, jw, jc, group_size=group)
    got, taux = TL.moe_block(tx, tw, tc, group_size=group)
    assert got.shape == (2, S, tc.d_model) and got.dtype == TDT[dt]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dt], rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), atol=TOL[dt])
    r = TL.moe_route(tx, tw["router"], tc, group_size=group)
    G = min(group, S)
    assert r["G"] == G and r["pad"] == (-S) % G
    assert r["C"] == int(np.ceil(G * tc.experts_per_token /
                                 tc.num_experts * tc.capacity_factor))
    drops = int((~r["keep"]).sum())
    if forced:
        # expert 1 takes every token's first choice: all but C of each
        # group's tokens are dropped there
        assert drops >= r["topi"].shape[0] * (G - r["C"])
        assert (r["topi"][..., 0] == 1).all()


def test_moe_route_drops_only_padding_for_padding():
    """Padding tokens come after a row's real ones in (token, k) order, so
    they can be dropped but never push a real token out: a row's real
    tokens keep the slots they have without the padding."""
    tc = tconfigs.get_reduced(ARCH)
    w = _weights(tc, forced=True)
    x = torch.from_numpy(_inputs(tc, 13, True, seed=13)[:1])
    router = torch.from_numpy(w["router"])
    padded = TL.moe_route(x, router, tc, group_size=8)     # 16 slots, 3 pad
    alone = TL.moe_route(x[:, 8:], router, tc, group_size=5)
    assert padded["pad"] == 3 and alone["pad"] == 0
    # the second group's real tokens: the same choices and slots as
    # without the padding (C differs with G: keep is checked at one C)
    real = slice(0, 5)
    assert torch.equal(padded["topi"][1, real], alone["topi"][0])
    assert torch.equal(padded["pos"][1, real], alone["pos"][0])
    assert torch.equal(padded["keep"][1, real],
                       alone["pos"][0] < padded["C"])
    assert not padded["keep"][1, 5:].all()       # padding was dropped


# ---------------- executor: token parity on the batched paged path --------

def test_phi35_moe_batched_executor_matches_jax_executor():
    from test_torch_executor import (SPECS, TAlloc, _drive, _jax_tokens,
                                     _port, treq)
    from test_torch_executor import CHUNK, PREEMPT_AT, VICTIM
    want = _jax_tokens(ARCH, "batched")
    ex = _port(arch=ARCH)
    assert not ex.legacy and ex.paged_ok
    got = _drive(ex, TAlloc, treq, SPECS, CHUNK, PREEMPT_AT, VICTIM)
    assert got == want
    assert [len(got[f"ex{i}"]) for i in range(len(SPECS))] == \
        [o for _, o in SPECS]
    assert len(ex.recompile_keys) <= ex.recompile_bound()
