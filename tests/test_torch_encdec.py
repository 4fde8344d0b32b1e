"""The port's whisper encoder-decoder against the JAX package's, on the
same seeded numpy inputs and bridged weights (reduced whisper-base:
LayerNorm, sinusoidal positions, GELU MLP; q/k/v projections at fan-in
D, see ``torch_parity.fan_in_d``): ``encode`` over stub frames,
and a DEC_ATTN block — causal self-attention over a dense cache, cross
attention over the encoder output (written into the slot's ``ck``/``cv``)
and then, at the next step, over the cached ``ck``/``cv``, and the same
block with no cache. Within 2e-5 in f32; in bf16 within 2e-2 of each
JAX tensor's scale (max and rms, as tests/test_torch_recurrent.py
states). Then the emitted tokens of the port's ``ModelExecutor`` on the
dense-slot path against the JAX ``ModelExecutor``'s, in f32: identical
(in serving no frames are passed, so the decoder reads the slot's zeroed
cross K/V on both sides)."""
import numpy as np
import pytest
import torch
from torch_parity import (both, bridge, close, fan_in_d, jax_cfg_f32,
                          jax_params_numpy, normal, rng, torch_cfg)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import DEC_ATTN  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.rope import rope_tables  # noqa: E402

ARCH = "whisper-base"
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _setup(dt):
    jc = jconfigs.get_reduced(ARCH)
    np_params = fan_in_d(jax_params_numpy(jax_cfg_f32(jc), jitter=0.05),
                         jc.num_heads, jc.d_model)
    tc = torch_cfg(tconfigs.get_reduced(ARCH), TDT[dt])
    tp = TT.cast_params(bridge(np_params, tc), tc.dtype)
    # the same dt-rounded values on both sides
    jp = jax.tree.map(lambda a: both(a, dt)[0], np_params)
    return jc, jp, tc, tp


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_encode_matches_jax(dt):
    jc, jp, tc, tp = _setup(dt)
    jf, tf = both(normal(rng(31), 2, jc.encoder_seq, jc.d_model), dt)
    want = jax.jit(lambda p, f: JT.encode(p, jc, f))(jp, jf)
    got = TT.encode(tp, tc, tf)
    assert got.dtype == TDT[dt]
    close(got, want, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_dec_attn_block_matches_jax_with_frames_then_cached_cross_kv(dt):
    """Block 0 of the decoder over a dense cache: a 7-token prefill with
    the encoder output (cross K/V computed and cached), then a decode step
    reading the cached cross K/V; and the prefill without a cache."""
    jc, jp, tc, tp = _setup(dt)
    jbp = jax.tree.map(lambda a: a[0], jp["stages"][0]["b0"])
    tbp = TT.layer_params(tp, tc)[0]["b0"][0]
    g = rng(32)
    je, te = both(normal(g, 2, jc.encoder_seq, jc.d_model), dt)
    B, KV, hd, Smax = 2, jc.num_kv_heads, jc.hd, 16
    shapes = {"k": (B, Smax, KV, hd), "v": (B, Smax, KV, hd),
              "ck": (B, jc.encoder_seq, KV, hd),
              "cv": (B, jc.encoder_seq, KV, hd)}
    jcache = {k: jnp.zeros(s, JDT[dt]) for k, s in shapes.items()}
    tcache = {k: torch.zeros(s, dtype=TDT[dt]) for k, s in shapes.items()}
    jfn = jax.jit(lambda x, bp, cache, enc, pos, idx: JT._apply_attnish(
        x, bp, DEC_ATTN, jc, positions=pos, q_start=idx, cache=cache,
        enc_out=enc, idx=idx))
    for start, n, frames in ((0, 7, True), (7, 1, False)):
        jx, tx = both(normal(g, 2, n, jc.d_model), dt)
        pos = np.tile(start + np.arange(n, dtype=np.int32), (2, 1))
        want, jcache, _ = jfn(jx, jbp, jcache, je if frames else None,
                              jnp.asarray(pos), jnp.int32(start))
        got, _ = TT._apply_attnish(
            tx, tbp, DEC_ATTN, tc, rope=None, q_start=start,
            cache=dict(tcache, idx=start), enc_out=te if frames else None)
        close(got, want, dt, f"block output at {start}")
        for k in shapes:
            close(tcache[k], jcache[k], dt, f"cache {k} at {start}")
    jx, tx = both(normal(g, 2, 5, jc.d_model), dt)
    want, _, _ = JT._apply_attnish(
        jx, jbp, DEC_ATTN, jc, positions=jnp.arange(5)[None], q_start=0,
        cache=None, enc_out=je, idx=None)
    got, _ = TT._apply_attnish(tx, tbp, DEC_ATTN, tc, rope=rope_tables(
        torch.arange(5)[None], tc.hd, tc.rope_theta, tc.rope_style),
        q_start=0, cache=None, enc_out=te)
    close(got, want, dt, "no cache")


def test_whisper_executor_matches_jax_executor():
    from test_torch_executor import (CHUNK, PREEMPT_AT, VICTIM, TAlloc,
                                     _drive, _jax_tokens, _port, treq)
    specs = [(24, 5), (12, 4), (36, 4), (24, 3)]
    want = _jax_tokens(ARCH, "legacy", specs)
    ex = _port(arch=ARCH)
    assert ex.legacy and not ex.paged_ok      # cross attention: dense slots
    got = _drive(ex, TAlloc, treq, specs, CHUNK, PREEMPT_AT, VICTIM)
    assert got == want
    assert [len(got[f"ex{i}"]) for i in range(len(specs))] == \
        [o for _, o in specs]
