"""Parameter declaration system.

Models declare parameters as trees of :class:`ParamDecl` — shape + logical
axis names + initializer. From one declaration tree we derive materialized
parameters (``init_params``, drawn from a seeded ``torch.Generator``) and
parameter counts. A tree is nested dicts and lists with ``ParamDecl``
leaves; a materialized tree has ``torch.Tensor`` leaves at the same paths.

``from_jax_numpy`` is the weight bridge: ``jax.random`` streams cannot be
reproduced in torch, so tests that hold the port against the JAX package
materialize the JAX parameters, convert them to numpy, and carry them over
path for path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    """Declaration of a single parameter tensor."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis name per dim (None = replicated)
    init: str = "normal"  # normal | zeros | ones | fill
    scale: float | None = None  # stddev; default fan-in
    dtype: Any = torch.float32
    fill: float = 0.0  # used when init == "fill"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} / axes {self.axes} mismatch")


def decl(shape, axes, init="normal", scale=None, dtype=torch.float32,
         fill=0.0) -> ParamDecl:
    return ParamDecl(tuple(int(s) for s in shape), tuple(axes), init, scale,
                     dtype, fill)


def _is_decl(x) -> bool:
    return isinstance(x, ParamDecl)


def tree_map(fn: Callable, tree, is_leaf: Callable = _is_decl):
    """Map ``fn`` over the leaves of a nested dict/list/tuple tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not is_leaf(tree):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def tree_leaves(tree, is_leaf: Callable = _is_decl) -> list:
    """Leaves in the order ``tree_map`` visits them (dict keys sorted, as
    ``jax.tree`` flattens them, so leaf ``i`` names the same parameter on
    both sides)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)) and not is_leaf(tree):
        return [x for v in tree for x in tree_leaves(v, is_leaf)]
    return [tree]


def tree_map_decls(fn: Callable[[ParamDecl], Any], decls):
    return tree_map(fn, decls, _is_decl)


def _materialize(d: ParamDecl, gen: torch.Generator, dtype, device):
    dt = dtype or d.dtype
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dt, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dt, device=device)
    if d.init == "fill":
        return torch.full(d.shape, d.fill, dtype=dt, device=device)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    scale = d.scale if d.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * scale).to(device=device, dtype=dt)


def init_params(decls, gen: torch.Generator, dtype=None, device="cpu"):
    """Materialize a declaration tree. Leaves draw from ``gen`` in
    ``tree_leaves`` order, so one seed gives one set of weights on any
    device the generator lives on."""
    made = iter([_materialize(d, gen, dtype, device)
                 for d in tree_leaves(decls)])
    return _unflatten(decls, made)


def _unflatten(decls, leaves):
    """Rebuild ``decls``' structure from ``leaves`` in ``tree_leaves``
    order."""
    if isinstance(decls, dict):
        filled = {k: _unflatten(decls[k], leaves) for k in sorted(decls)}
        return {k: filled[k] for k in decls}
    if isinstance(decls, (list, tuple)) and not _is_decl(decls):
        return type(decls)(_unflatten(v, leaves) for v in decls)
    return next(leaves)


def param_count(decls) -> int:
    return sum(int(np.prod(d.shape)) for d in tree_leaves(decls))


def from_jax_numpy(tree, decls, device="cpu", path="params"):
    """Convert a JAX parameter tree whose leaves are numpy arrays into the
    port's tree, path for path, checking every leaf against ``decls``.

    Raises ``KeyError``/``ValueError`` on any missing key, extra key, or
    shape mismatch, naming the path."""
    if isinstance(decls, ParamDecl):
        a = np.asarray(tree)
        if tuple(a.shape) != decls.shape:
            raise ValueError(f"{path}: shape {tuple(a.shape)} != declared "
                             f"{decls.shape}")
        return torch.from_numpy(np.array(a, copy=True)).to(device)
    if isinstance(decls, dict):
        if not isinstance(tree, dict) or set(tree) != set(decls):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise KeyError(f"{path}: keys {got} != declared {sorted(decls)}")
        return {k: from_jax_numpy(tree[k], decls[k], device, f"{path}.{k}")
                for k in decls}
    if isinstance(decls, (list, tuple)):
        if len(tree) != len(decls):
            raise ValueError(f"{path}: {len(tree)} entries != declared "
                             f"{len(decls)}")
        return type(decls)(from_jax_numpy(t, d, device, f"{path}[{i}]")
                           for i, (t, d) in enumerate(zip(tree, decls)))
    raise TypeError(f"{path}: unexpected declaration node {type(decls)}")
