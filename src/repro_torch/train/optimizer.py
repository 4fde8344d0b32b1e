"""AdamW and the cosine schedule, with the JAX package's arithmetic.

Moments are f32 regardless of param dtype (mixed-precision master states).
``adamw_update`` writes the parameters and both moments in place under
``torch.no_grad()``: at full-width qwen2-vl-2b (1.777 B parameters) the
f32 parameters, gradients and moments are 28.4 GB, and a functional
update would hold a second copy of the parameters and moments during the
step. A tree is the nested dicts and lists of ``model_decls`` with tensor
leaves, taken in ``tree_leaves`` order (the order ``jax.tree`` flattens
the same tree in).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.sharding import settle, total


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32, on the parameters' device
    mu: dict
    nu: dict


def leaves(tree) -> list:
    """A tensor tree's leaves (a flat list of tensors is its own)."""
    return tree_leaves(tree, is_leaf=torch.is_tensor)


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    step = torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)
    return AdamWState(step, tree_map(zeros, params, is_leaf=torch.is_tensor),
                      tree_map(zeros, params, is_leaf=torch.is_tensor))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr=3e-4, b1=0.9,
                 b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0):
    """One AdamW step. ``grads`` is a tree like ``params`` or its leaves as
    a list. Writes ``params``, ``state.mu`` and ``state.nu`` in place and
    returns (params, the state with its step advanced, the global gradient
    norm before clipping)."""
    # each gradient laid out as its parameter (under sharding rules)
    flat_g = settle(leaves(grads), leaves(params))
    # global-norm clip
    gnorm = torch.sqrt(total(g.to(torch.float32).square().sum()
                             for g in flat_g))
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    for g, m, v, p in zip(flat_g, leaves(state.mu), leaves(state.nu),
                          leaves(params), strict=True):
        g = g.to(torch.float32) * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        p32 = p.to(torch.float32)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p32
        p.copy_(p32 - lr * delta)      # rounded once to the param's dtype
    return params, AdamWState(step, state.mu, state.nu), gnorm


def cosine_lr(step, *, base_lr=3e-4, warmup=100, total=10000, min_frac=0.1):
    """Linear warmup to ``base_lr``, then a cosine down to ``min_frac`` of
    it at ``total``; f32 from an int32 step (a tensor or an int)."""
    t = torch.as_tensor(step).to(torch.float32)
    warm = t / max(warmup, 1)
    prog = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * torch.where(t < warmup, warm, cos)
