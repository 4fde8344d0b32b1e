"""The port's recurrent blocks against the JAX package's on the same
seeded numpy inputs and bridged weights: ``mamba_block`` (a 300-token
prefill across the 256-token chunk boundary of the JAX scan, then decode
steps from the cached ``conv``/``ssm`` state), ``mlstm_block`` and
``slstm_block`` (a prefill, then decode steps from the state). Outputs
and states within 2e-5 in f32; in bf16 (the same bf16 values on both
sides; the states stay f32, the Mamba conv state takes the cache's dtype)
within 2e-2 of each JAX tensor's scale (``torch_parity.close``): two bf16
evaluations of these blocks part by an ulp or two of their largest
intermediates, a few hundredths at outputs of ~6 — the JAX package's own
jitted and eager bf16 ``mamba_block`` differ by 0.03 on the 300-token
case."""
import numpy as np
import pytest
import torch
from torch_parity import (both, close, jax_cfg_f32, jax_params_numpy, normal,
                          rng)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402

TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _block_weights(arch, block, sub, dt):
    """Layer 0 of block ``block``'s ``sub`` subtree of the reduced arch's
    JAX weights (jittered, so zero-initialised leaves are exercised), on
    both sides in ``dt``."""
    jc = jax_cfg_f32(jconfigs.get_reduced(arch))
    tree = jax_params_numpy(jc, jitter=0.05)["stages"][0][block][sub]
    jw, tw = {}, {}
    for k, a in tree.items():
        jw[k], tw[k] = both(a[0], dt)
    return jw, tw


def _run(jfn, tfn, jw, tw, jstate, tstate, steps, d_model, dt):
    """Feed ``steps`` chunk lengths through both blocks, each from the
    state the last one left; compare every output and state."""
    g = rng(21)
    for n in steps:
        jx, tx = both(normal(g, 2, n, d_model), dt)
        jy, jstate = jfn(jx, jw, cache=jstate)
        ty, tstate = tfn(tx, tw, cache=tstate)
        assert ty.shape == (2, n, d_model) and ty.dtype == TDT[dt]
        close(ty, jy, dt, f"output, chunk of {n}")
        for k in jstate:
            assert str(tstate[k].dtype) == "torch." + jstate[k].dtype.name
            close(tstate[k], jstate[k], dt, f"state {k}, chunk of {n}")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mamba_block_matches_jax_across_chunks_then_decode(dt):
    arch = "jamba-1.5-large-398b"
    jc, tc = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    jw, tw = _block_weights(arch, "b0", "mamba", dt)
    B, DI, N, KC = 2, jc.d_inner, jc.mamba_d_state, jc.mamba_d_conv
    jstate = {"conv": jnp.zeros((B, KC - 1, DI), JDT[dt]),
              "ssm": jnp.zeros((B, DI, N), jnp.float32)}
    tstate = {"conv": torch.zeros((B, KC - 1, DI), dtype=TDT[dt]),
              "ssm": torch.zeros((B, DI, N))}
    jfn = jax.jit(lambda x, p, cache: JS.mamba_block(x, p, jc, cache=cache))

    def tfn(x, p, cache):
        return TS.mamba_block(x, p, tc, cache=cache)
    _run(jfn, tfn, jw, tw, jstate, tstate, (300, 1, 1, 2), jc.d_model, dt)


def test_mamba_block_without_cache_starts_from_zero_state():
    arch = "jamba-1.5-large-398b"
    tc = tconfigs.get_reduced(arch)
    _, tw = _block_weights(arch, "b0", "mamba", "f32")
    x = torch.from_numpy(normal(rng(22), 1, 9, tc.d_model))
    a, sa = TS.mamba_block(x, tw, tc)
    zero = {"conv": torch.zeros((1, tc.mamba_d_conv - 1, tc.d_inner)),
            "ssm": torch.zeros((1, tc.d_inner, tc.mamba_d_state))}
    b, sb = TS.mamba_block(x, tw, tc, cache=zero)
    assert torch.equal(a, b)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_block_matches_jax_prefill_then_decode(kind, dt):
    arch = "xlstm-125m"
    jc, tc = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    block = {"mlstm": "b0", "slstm": "b1"}[kind]
    jw, tw = _block_weights(arch, block, "core", dt)
    H, B = jc.num_heads, 2
    if kind == "mlstm":
        hd = int(jc.xlstm_proj_factor * jc.d_model) // H
        shapes = {"C": (B, H, hd, hd), "n": (B, H, hd), "m": (B, H)}
        fill = {"C": 0.0, "n": 0.0, "m": -1e30}
        jfn = jax.jit(lambda x, p, cache: JX.mlstm_block(x, p, jc,
                                                         cache=cache))

        def tfn(x, p, cache):
            return TX.mlstm_block(x, p, tc, cache=cache)
    else:
        hd = jc.d_model // H
        shapes = {k: (B, H, hd) for k in ("c", "n", "m", "h")}
        fill = {"c": 0.0, "n": 1.0, "m": 0.0, "h": 0.0}
        jfn = jax.jit(lambda x, p, cache: JX.slstm_block(x, p, jc,
                                                         cache=cache))

        def tfn(x, p, cache):
            return TX.slstm_block(x, p, tc, cache=cache)
    jstate = {k: jnp.full(s, fill[k], jnp.float32) for k, s in shapes.items()}
    tstate = {k: torch.full(s, fill[k]) for k, s in shapes.items()}
    _run(jfn, tfn, jw, tw, jstate, tstate, (12, 1, 1), jc.d_model, dt)
