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


def bridge(np_tree, tcfg):
    """numpy JAX tree -> the port's f32 master tree, checked path for path."""
    from repro_torch.models import transformer as TT
    from repro_torch.models.params import from_jax_numpy
    return from_jax_numpy(np_tree, TT.model_decls(tcfg))
