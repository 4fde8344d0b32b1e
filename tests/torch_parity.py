"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: seeded numpy inputs for both sides and the weight bridge.

Imported by ``tests/test_torch_*.py`` only; it is not a test module.
"""
import dataclasses
import functools

import numpy as np
import torch

# the port's tests run at small shapes; a single intra-op thread keeps them
# from competing with the other test workers for cores
torch.set_num_threads(1)


def rng(seed: int = 0) -> np.random.Generator:
    return np.random.default_rng(seed)


def normal(g: np.random.Generator, *shape) -> np.ndarray:
    return g.standard_normal(shape).astype(np.float32)


TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}


def both(a, dt: str):
    """The same values on both sides, rounded to ``dt`` ('f32' or 'bf16')
    once: (JAX array, torch tensor)."""
    import jax.numpy as jnp
    t = torch.from_numpy(np.asarray(a, np.float32)).to(TORCH_DT[dt])
    jdt = jnp.float32 if dt == "f32" else jnp.bfloat16
    return jnp.asarray(t.float().numpy()).astype(jdt), t


def close(got, want, dt: str, what: str = "", tol=None):
    """The port's tensor ``got`` against the JAX array ``want``: within
    2e-5 absolute in f32; in bf16 within 2e-2 of ``want``'s scale (max
    error at most 2e-2 of its max, rms error at most 2e-2 of its rms),
    since two bf16 evaluations of a block part by an ulp or two of its
    largest intermediates, whichever rounds where."""
    import jax.numpy as jnp
    tol = tol if tol is not None else {"f32": 2e-5, "bf16": 2e-2}[dt]
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if dt == "f32":
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=what)
        return
    d = g - w
    assert np.abs(d).max() <= tol * np.abs(w).max(), what
    assert np.sqrt(np.mean(d * d)) <= tol * np.sqrt(np.mean(w * w)), what


def jax_cfg_f32(cfg):
    import jax.numpy as jnp
    return dataclasses.replace(cfg, dtype=jnp.float32)


def torch_cfg(cfg, dtype):
    return dataclasses.replace(cfg, dtype=dtype)


@functools.lru_cache(maxsize=None)
def jax_params_numpy(jcfg, seed: int = 0, jitter: float = 0.0):
    """JAX ``init_params`` weights as a numpy tree. ``jitter`` adds seeded
    noise to every leaf, relative to the leaf's own spread (absolute for
    constant leaves), so that zero-initialised biases and norm scales are
    exercised too. Cached per arguments: callers must not mutate it."""
    import jax
    from repro.models import transformer as JT
    from repro.models.params import init_params
    # jitted: one compile for the tree instead of one per eager op
    init = jax.jit(functools.partial(init_params, JT.model_decls(jcfg)))
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))
    if jitter:
        g = rng(seed + 1)
        tree = jax.tree.map(
            lambda a: (a + jitter * (a.std() or 1.0) *
                       g.standard_normal(a.shape)).astype(a.dtype), tree)
    return tree


def fan_in_d(tree, H, D):
    """A copy of a numpy weight tree with every attention q/k/v projection
    (a stacked ``(layers, D, heads, hd)`` leaf named wq, wk or wv) scaled
    to fan-in D: both packages draw such a projection with fan-in
    ``heads`` (the ParamDecl rule reads the second-to-last axis), which at
    reduced widths gives attention logits of std ~32, a one-hot softmax,
    and outputs that move by 1e-3 on last-bit differences of f32 matmuls.
    With fan-in D the logits have std ~1."""
    if isinstance(tree, dict):
        return {k: (v * np.sqrt(H / D)).astype(v.dtype)
                if k in ("wq", "wk", "wv") and np.ndim(v) == 4
                else fan_in_d(v, H, D) for k, v in tree.items()}
    if isinstance(tree, list):
        return [fan_in_d(v, H, D) for v in tree]
    return tree


def bridge(np_tree, tcfg):
    """numpy JAX tree -> the port's f32 master tree, checked path for path."""
    from repro_torch.models import transformer as TT
    from repro_torch.models.params import from_jax_numpy
    return from_jax_numpy(np_tree, TT.model_decls(tcfg))
