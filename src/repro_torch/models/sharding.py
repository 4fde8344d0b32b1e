"""Logical-axis sharding rules + activation sharding context.

Rules map *logical* axis names (used in ParamDecls and activation
annotations) to mesh axis names. The dry-run installs a rule set + a
``DeviceMesh`` via :func:`use_rules`; in serving, training and the tests
no rules are installed and every annotation returns its input unchanged.

With rules installed the model runs on ``DTensor``s: :func:`shard_act`
redistributes an activation to the placements its logical axes name (the
counterpart of ``with_sharding_constraint``), and :func:`replicate`
lifts a plain tensor the model builds itself (an ``arange``, a mask, a
rope table) to a replicated ``DTensor`` on the mesh, so that it can meet
the sharded ones, and :func:`einsum` computes a product on each rank's
shards where DTensor's own would fold two sharded dims into one.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any

import torch

from .params import PartitionSpec, logical_to_pspec, placements

# Baseline rule sets -------------------------------------------------------

# Training: batch over data(+pod), TP over model, FSDP(ZeRO-3-ish) of params
# over data on the embed dim.
TRAIN_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": "data",          # FSDP shard of params along d_model
    "embed_act": None,         # activations' d_model dim
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": None,
    "expert_mlp": "model",
    "vocab": "model",
    "conv": None,
    "state": None,
    "inner": "model",          # mamba/xlstm inner dim
}

# Serving (decode/prefill): no optimizer, params TP over model, replicated
# over data; batch over (pod, data).
SERVE_RULES: dict[str, Any] = {**TRAIN_RULES, "embed": None}

# Long-context decode, batch=1: KV-cache sequence dim context-parallel over
# data; batch replicated.
LONG_CTX_RULES: dict[str, Any] = {
    **SERVE_RULES,
    "batch": None,
    "cache_seq": "data",
}


class _Ctx(threading.local):
    def __init__(self):
        self.rules: dict[str, Any] | None = None
        self.mesh = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_rules(rules: dict[str, Any], mesh):
    prev = (_CTX.rules, _CTX.mesh)
    _CTX.rules, _CTX.mesh = rules, mesh
    try:
        yield
    finally:
        _CTX.rules, _CTX.mesh = prev


def current_rules() -> dict[str, Any] | None:
    return _CTX.rules


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard_act(x, *axes: str | None):
    """Constrain activation sharding by logical axes: ``x`` itself without
    rules or when it is not a ``DTensor``; else ``x`` redistributed to the
    placements the axes name on the rules' mesh. As with
    ``with_sharding_constraint``, the gradient is held to the same
    placements on its way back."""
    if _CTX.rules is None or _CTX.mesh is None or not _is_dtensor(x):
        return x
    mesh = _CTX.mesh
    pl = placements(logical_to_pspec(tuple(axes), _CTX.rules), mesh)
    y = x.redistribute(mesh, pl)
    if y.requires_grad:
        y.register_hook(lambda g: g.redistribute(mesh, pl))
    return y


def replicate(t):
    """A plain tensor the model made (an index, a mask, a table) as a
    replicated ``DTensor`` on the rules' mesh; ``t`` itself without rules
    or when it already is one."""
    if _CTX.rules is None or _CTX.mesh is None or _is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, _CTX.mesh,
                              [Replicate()] * _CTX.mesh.ndim,
                              run_check=False)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, with its gradient made contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def einsum(eq: str, *ops):
    """``torch.einsum``; under sharding rules, on ``DTensor`` operands that
    each mesh dim shards along at most one letter (partial sums summed
    first; replicated operands that have the letter cut to their shard of
    it, locally), the product of each rank's shards: sharded along that letter, or a partial
    sum where the letter is contracted. DTensor itself would fold two
    sharded batch dims (batch over data, heads over model) into one for
    its batched product, which torch before 2.12 refuses; other operands
    go to ``torch.einsum``.

    Remove it (callers use ``torch.einsum``) once the dry-run's machines
    all have torch 2.12 or later, and the reduced pairs of
    tests/test_torch_dryrun.py and chip_smoke.py's dry-run phase keep
    their collective counts without it."""
    if _CTX.rules is None or not all(_is_dtensor(o) for o in ops):
        return torch.einsum(eq, *ops)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    lhs, out = eq.replace(" ", "").split("->")
    specs = lhs.split(",")
    mesh = ops[0].device_mesh
    # an operand's partial sums are summed first (an all-reduce, as XLA
    # reduces them before a product that needs them whole)
    ops = [o.redistribute(mesh, [Replicate() if p.is_partial() else p
                                 for p in o.placements]) for o in ops]
    want = [list(o.placements) for o in ops]
    pl = []
    for m in range(mesh.ndim):
        letters = {spec[o.placements[m].dim] for spec, o in zip(specs, ops)
                   if type(o.placements[m]) is Shard}
        if len(letters) > 1 or not all(
                type(o.placements[m]) is Shard or
                o.placements[m].is_replicate() for o in ops):
            return torch.einsum(eq, *ops)
        if not letters:
            pl.append(Replicate())
            continue
        (letter,) = letters
        for w, spec in zip(want, specs):
            if letter in spec:
                w[m] = Shard(spec.index(letter))
        pl.append(Shard(out.index(letter)) if letter in out else Partial())
    size = {c: n for spec, o in zip(specs, ops) for c, n in zip(spec,
                                                                o.shape)}
    shape = torch.Size([size[c] for c in out])
    # every local tensor and its gradient contiguous, as the strides of
    # their DTensors say: DTensor hands a local gradient back in whatever
    # layout the local ops left it, and views it by the declared stride
    local = _ContiguousGrad.apply(torch.einsum(eq, *(
        _ContiguousGrad.apply(o.redistribute(mesh, w).contiguous()
                              .to_local())
        for o, w in zip(ops, want))).contiguous())
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, pl, shape=shape, stride=stride,
                              run_check=False)


def act_pspec(*axes: str | None) -> PartitionSpec:
    if _CTX.rules is None:
        return PartitionSpec()
    return logical_to_pspec(tuple(axes), _CTX.rules)
