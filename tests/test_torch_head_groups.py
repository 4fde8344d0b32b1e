"""The four attention and MoE decoders of the batched paged path at their
published head groups, against the JAX package: chatglm3-6b (H=32, KV=2,
G=16, half RoPE, qkv bias), deepseek-coder-33b (56/8, G=7),
qwen1.5-110b (64/8, G=8, qkv bias) and grok-1-314b (48/8, G=6,
attention softcap 30, 8 experts top-2). Their reduced configs keep G at
2 or 4; here each published config is cut to 2 layers, hd 16 and the
reduced configs' d_model 256, d_ff 512 and vocab 512, with its H and KV,
rope style, qkv bias, softcap and experts as published.

With the JAX ``init_params`` weights carried over by ``from_jax_numpy``
(q/k/v scaled to fan-in D, ``torch_parity.fan_in_d``, so that attention
rows are not one-hot and last-bit differences are not amplified):
the port's batched executor (the gather path, and the kernels' plain
versions) emits the JAX ``ModelExecutor``'s tokens under
tests/test_torch_executor.py's schedule (ragged chunked prefill, fused
decode, a preemption, a prompt past the context window), and the paged
forward's logits over a ragged prefill chunk and a decode step stay
within tests/test_torch_model.py's tolerances (1e-4 in f32, 5e-2
absolute plus relative in bf16). Both packages round K and V through bf16
before they store them, so an element whose f32 value lies at a bf16
rounding boundary can round apart; at d_model H·hd one or two of ~10^4
elements do, and the f32 logits then part by 2e-5 to 2e-4 (growing
about tenfold a layer); at these widths none does."""
import dataclasses

import numpy as np
import pytest
import torch
from test_torch_executor import (CHUNK, JITTER, MAX_LEN, PAGE, PREEMPT_AT,
                                 SPECS, VICTIM, _drive, _jax_executor)
from test_torch_model import (PAGE as FWD_PAGE, PPL, _jax_forward, _steps,
                              _torch_forward)
from torch_parity import (bridge, fan_in_d, jax_cfg_f32, jax_params_numpy,
                          torch_cfg)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.cache import BlockAllocator as JAlloc  # noqa: E402
from repro.cache.paged import PagedStackStore as JStore  # noqa: E402
from repro.serving import request as jreq  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.cache import BlockAllocator as TAlloc  # noqa: E402
from repro_torch.cache.paged import PagedStackStore as TStore  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import executors as texec  # noqa: E402
from repro_torch.serving import request as treq  # noqa: E402

# arch -> its published group G = H / KV
GROUPS = {"chatglm3-6b": 16, "deepseek-coder-33b": 7, "qwen1.5-110b": 8,
          "grok-1-314b": 6}
CUT = dict(num_layers=2, d_model=256, head_dim=16, d_ff=512, vocab_size=512,
           max_seq_len=512)


def _cut(configs, arch):
    """The published config, cut in depth and width; its heads, groups
    and everything else as published."""
    return dataclasses.replace(configs.get_config(arch), **CUT)


def test_cuts_keep_the_published_head_groups():
    for arch, G in GROUPS.items():
        full, jc, tc = (tconfigs.get_config(arch), _cut(jconfigs, arch),
                        _cut(tconfigs, arch))
        assert {k: v for k, v in vars(jc).items() if k != "dtype"} == \
            {k: v for k, v in vars(tc).items() if k != "dtype"}
        assert (tc.num_heads, tc.num_kv_heads, tc.hd) == \
            (full.num_heads, full.num_kv_heads, 16)
        assert tc.num_heads // tc.num_kv_heads == G
        for k in ("rope_style", "qkv_bias", "logit_softcap", "num_experts",
                  "experts_per_token"):
            assert getattr(tc, k) == getattr(full, k), (arch, k)
        assert TT.paged_supported(tc)


_JAX_TOKENS, _JAX_LOGITS = {}, {}


def _weights(jc, jitter):
    """The JAX weights as numpy, q/k/v at fan-in D."""
    return fan_in_d(jax_params_numpy(jc, jitter=jitter), jc.num_heads,
                    jc.d_model)


def _jax_tokens(arch):
    """The JAX executor's emitted tokens under ``_drive``, once an arch."""
    if arch not in _JAX_TOKENS:
        jc = jax_cfg_f32(_cut(jconfigs, arch))
        ex = _jax_executor(jc)
        ex.params = jax.tree.map(jnp.asarray, _weights(jc, JITTER))
        _JAX_TOKENS[arch] = _drive(ex, JAlloc, jreq, SPECS, CHUNK,
                                   PREEMPT_AT, VICTIM)
    return _JAX_TOKENS[arch]


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("arch", list(GROUPS))
def test_executor_emits_the_jax_tokens(arch, impl):
    want = _jax_tokens(arch)
    jc = jax_cfg_f32(_cut(jconfigs, arch))
    tc = dataclasses.replace(_cut(tconfigs, arch), dtype=torch.float32)
    ex = texec.ModelExecutor(
        tc, texec.ExecutorConfig(max_slots=4, max_len=MAX_LEN,
                                 page_size=PAGE, attn_impl=impl),
        device="cpu", params=bridge(_weights(jc, JITTER), tc))
    assert not ex.legacy and ex.attn_impl == impl
    got = _drive(ex, TAlloc, treq, SPECS, CHUNK, PREEMPT_AT, VICTIM)
    assert got == want
    assert [len(got[f"ex{i}"]) for i in range(len(SPECS))] == \
        [o for _, o in SPECS]


def _jax_logits(arch, dt):
    """JAX logits for (prefill, decode), once an (arch, dtype)."""
    if (arch, dt) not in _JAX_LOGITS:
        jc = _cut(jconfigs, arch)
        if dt == "f32":
            jc = jax_cfg_f32(jc)
        jp = jax.tree.map(jnp.asarray, _weights(jax_cfg_f32(jc), 0.05))
        stores = [{f"b{i}": JStore.build(r, PPL, FWD_PAGE, jc.num_kv_heads,
                                         jc.hd) for i, _ in enumerate(p)}
                  for p, r in jc.stages()]
        out = []
        for step in _steps(jc.vocab_size):
            lg, stores = _jax_forward(jc, jp, stores, *step)
            out.append(lg)
        _JAX_LOGITS[arch, dt] = out
    return _JAX_LOGITS[arch, dt]


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", list(GROUPS))
def test_paged_forward_matches_jax(arch, dt, impl):
    ref = _jax_logits(arch, dt)
    jc = _cut(jconfigs, arch)
    tc = torch_cfg(_cut(tconfigs, arch),
                   torch.float32 if dt == "f32" else torch.bfloat16)
    tp = TT.cast_params(bridge(_weights(jax_cfg_f32(jc), 0.05), tc),
                        tc.dtype)
    stores = [{f"b{i}": TStore.build(r, PPL, FWD_PAGE, tc.num_kv_heads,
                                     tc.hd) for i, _ in enumerate(p)}
              for p, r in tc.stages()]
    for want, step in zip(ref, _steps(tc.vocab_size)):
        got = _torch_forward(tc, tp, stores, *step, impl)
        assert got.shape == want.shape == (2, 1, tc.vocab_size)
        assert np.isfinite(got).all()
        if dt == "f32":
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        else:
            np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)
