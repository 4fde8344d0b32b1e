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

from .params import PartitionSpec, logical_to_pspec, placements, tree_map

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
        self.trips = 1          # the ops run now stand for this many
        self.spans: list = []   # (first, last autograd node, trips)


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


def _next_node() -> int:
    """The sequence number the next autograd node will take (a node made
    and dropped to read it)."""
    return torch.zeros((), requires_grad=True).mul(1).grad_fn._sequence_nr()


@contextlib.contextmanager
def counted(n: int):
    """Ops run inside stand for ``n`` runs of themselves (the step of a
    recurrence run once for ``n`` tokens): ``trips`` says ``n`` while they
    run, and again while autograd runs their backward."""
    if n == 1:
        yield
        return
    prev = _CTX.trips
    first = _next_node() if torch.is_grad_enabled() else None
    _CTX.trips = prev * n
    try:
        yield
    finally:
        _CTX.trips = prev
        if first is not None:
            _CTX.spans.append((first, _next_node(), prev * n))


def trips() -> int:
    """How many runs the op being run now stands for (``counted``): the
    dry-run's counter multiplies its collectives and FLOPs by it."""
    if _CTX.trips > 1:
        return _CTX.trips
    node = torch._C._current_autograd_node()
    if node is not None and _CTX.spans:
        seq = node._sequence_nr()
        for first, last, n in _CTX.spans:
            if first < seq < last:
                return n
    return 1


def reset_trips() -> None:
    """Forget the spans ``counted`` has recorded (a new step)."""
    _CTX.trips, _CTX.spans = 1, []


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
    ops = [_to(o, [Replicate() if p.is_partial() else p
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
    # an operand without a mesh dim's letter gets a partial sum over that
    # dim for its gradient (the product's other operands are sharded along
    # the letter it is summed over)
    sharded = [next((spec[p.dim] for spec, p in zip(specs, w)
                     if type(p) is Shard), None) for w in zip(*want)]
    grad_pl = [[Partial() if c is not None and c not in spec else p
                for c, p in zip(sharded, w)] for spec, w in zip(specs, want)]
    # every local tensor and its gradient contiguous, as the strides of
    # their DTensors say: DTensor hands a local gradient back in whatever
    # layout the local ops left it, and views it by the declared stride
    local = _ContiguousGrad.apply(torch.einsum(eq, *(
        _ContiguousGrad.apply(_to(o, w).contiguous()
                              .to_local(grad_placements=gp))
        for o, w, gp in zip(ops, want, grad_pl))).contiguous())
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, pl, shape=shape, stride=stride,
                              run_check=False)


class _Gather(torch.autograd.Function):
    """``x.redistribute`` to ``pl`` (an all-gather of a parameter's FSDP
    shards), whose gradient goes back as it comes, partial sums and all:
    ``settle`` sums them once (DTensor's own backward would reduce-scatter
    each use)."""

    @staticmethod
    def forward(ctx, x, pl):
        return x.redistribute(x.device_mesh, pl)

    @staticmethod
    def backward(ctx, g):
        return g, None


def unshard(tree):
    """A layer's weights as it computes with them: under sharding rules
    each ``DTensor`` leaf all-gathered over the mesh dims its ``embed``
    axis is sharded on (FSDP, the training rules), once where the layer
    starts, as XLA gathers them; ``tree`` itself without rules."""
    if _CTX.rules is None or _CTX.mesh is None:
        return tree
    from torch.distributed.tensor import Replicate, Shard
    names = _CTX.rules.get("embed")
    names = {names} if isinstance(names, str) else set(names or ())
    mesh = _CTX.mesh
    fsdp = [i for i, n in enumerate(mesh.mesh_dim_names) if n in names]
    if not fsdp:
        return tree

    def one(t):
        if not _is_dtensor(t):
            return t
        pl = [Replicate() if i in fsdp and isinstance(p, Shard) else p
              for i, p in enumerate(t.placements)]
        return t if pl == list(t.placements) else _Gather.apply(t, pl)
    return tree_map(one, tree, is_leaf=torch.is_tensor)


def log_softmax(x):
    """``torch.log_softmax`` over the last dim; on a ``DTensor``, written
    out (max, then the log of the sum of exponentials), so that a
    vocab-sharded dim reduces its max and sum across the mesh, as XLA
    partitions it, where DTensor's own would gather the logits."""
    if not _is_dtensor(x):
        return torch.log_softmax(x, dim=-1)
    m = whole(x.amax(dim=-1, keepdim=True)).detach()
    return x - m - torch.log(whole(torch.exp(x - m).sum(dim=-1,
                                                         keepdim=True)))


def pick(x, idx):
    """``x[..., idx]`` for an index a row (``idx`` (...) int64): a gather;
    on a ``DTensor``, a masked sum over the last dim, which a sharded dim
    reduces across the mesh where DTensor's gather would gather ``x``."""
    if not _is_dtensor(x):
        return torch.gather(x, -1, idx[..., None])[..., 0]
    ids = replicate(torch.arange(x.shape[-1], device=idx.device))
    return whole(torch.where(ids == idx[..., None], x, 0.0).sum(dim=-1))


def whole(t):
    """A ``DTensor``'s partial sums summed (an all-reduce), its shards kept
    (DTensor may instead pick a reduce-scatter and an all-gather); ``t``
    itself when it is not one."""
    if not _is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [
        Replicate() if p.is_partial() else p for p in t.placements])


class _WholeGrad(torch.autograd.Function):
    """The identity, with its gradient's partial sums summed (``whole``)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return whole(g)


def whole_grad(t):
    """``t``; on a ``DTensor``, its gradient's partial sums summed (an
    all-reduce) before they reach the ops that made ``t``, as XLA reduces
    a product's partial input gradient (DTensor may leave them partial,
    or reduce-scatter them, as its version picks)."""
    return _WholeGrad.apply(t) if _is_dtensor(t) else t


def total(xs):
    """``sum(xs)`` of scalars that need no gradient. On ``DTensor``s, each
    rank's shares summed (a replicated scalar counts on the first rank of
    each mesh dim it is replicated over), then one all-reduce over the
    whole mesh (DTensor reduces each pair of scalars partial over
    different dims before adding them)."""
    xs = list(xs)
    if not xs or not _is_dtensor(xs[0]):
        return sum(xs)
    from torch.distributed.tensor import DTensor
    mesh, acc = xs[0].device_mesh, 0
    for x in xs:
        loc = x.to_local()
        if any(not p.is_partial() and mesh.get_local_rank(m) != 0
               for m, p in enumerate(x.placements)):
            loc = torch.zeros_like(loc)
        acc = acc + loc
    from torch.distributed._functional_collectives import all_reduce
    from torch.distributed.tensor import Replicate
    acc = all_reduce(acc, "sum", mesh._flatten() if mesh.ndim > 1 else mesh)
    return DTensor.from_local(acc, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def settle(grads, params) -> list:
    """Gradients (a list, in ``params``' order) laid out as their
    parameters: the partial sums summed first, whole (as XLA reduces a
    gradient, with no reduce-scatter), the gradients partial over the
    same mesh dims side by side in one all-reduce (as XLA combines a
    step's reductions), then each rank's shards. Plain tensors come back
    as they are; the update then issues no collective."""
    grads = list(grads)
    groups = {}
    for i, g in enumerate(grads):
        if _is_dtensor(g):
            dims = tuple(m for m, p in enumerate(g.placements)
                         if p.is_partial())
            if dims:
                groups.setdefault((dims, g.dtype), []).append(i)
    if not groups:
        return grads
    from torch.distributed._functional_collectives import all_reduce
    from torch.distributed.tensor import DTensor, Replicate
    for (dims, _), idx in groups.items():
        mesh = grads[idx[0]].device_mesh
        flat = torch.cat([grads[i].to_local().reshape(-1) for i in idx])
        for group in ([mesh._flatten()] if len(dims) == mesh.ndim > 1
                      else [(mesh, m) for m in dims]):
            flat = all_reduce(flat, "sum", group)
        at = 0
        for i in idx:
            g = grads[i]
            n = g.to_local().numel()
            grads[i] = DTensor.from_local(
                flat[at:at + n].reshape(g.to_local().shape), mesh,
                [Replicate() if p.is_partial() else p for p in g.placements],
                shape=g.shape, stride=g.stride(), run_check=False)
            at += n
    return [g.redistribute(g.device_mesh, p.placements) if _is_dtensor(g)
            else g for g, p in zip(grads, params, strict=True)]


def halves(x):
    """``x[..., :L/2], x[..., L/2:]`` for a last dim of L. Under sharding
    rules, where an even number n of ranks on a mesh dim shard that dim
    in 2n equal pieces or more (a projection's two outputs side by side,
    the dim divisible by 2n), each half comes out
    sharded over that mesh dim as ``x`` is, moved there as XLA moves it:
    rank r's piece of a half lives in the first or the second half of
    rank ``r // 2``'s shard of it, and four collective-permutes (each
    half to the even ranks and to the odd ones) bring the pieces over.
    DTensor itself would all-gather ``x`` to cut it."""
    L = x.shape[-1]
    if _CTX.rules is None or not _is_dtensor(x):
        return x[..., :L // 2], x[..., L // 2:]
    from torch.distributed.tensor import DTensor, Shard
    mesh = x.device_mesh
    dims = [m for m, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim in (-1, x.ndim - 1)]
    if len(dims) != 1 or mesh.size(dims[0]) % 2 or \
            L % (2 * mesh.size(dims[0])):
        return x[..., :L // 2], x[..., L // 2:]
    (m,) = dims
    n, r = mesh.size(m), mesh.get_local_rank(m)
    w = L // (2 * n)                    # a rank's piece of a half
    loc = x.to_local()
    out = []
    for h in (0, 1):                    # the half
        moved = []
        for e in (0, 1):                # to the even ranks, to the odd
            # sources: the ranks holding half h; rank h*n/2 + j sends
            # part e of its shard to rank 2j + e
            piece = loc[..., e * w:(e + 1) * w].contiguous()
            send, recv = [0] * n, [0] * n
            if h * n // 2 <= r < (h + 1) * n // 2:
                send[2 * (r - h * n // 2) + e] = piece.numel()
            if r % 2 == e:
                recv[h * n // 2 + r // 2] = piece.numel()
            moved.append(_permute(piece.reshape(-1)[:sum(send)], recv, send,
                                  (mesh, m)))
        # one of the two is empty here; both stay in the graph, so that
        # every rank runs both backward collectives
        got = torch.cat(moved).reshape(piece.shape)
        shape = x.shape[:-1] + (L // 2,)
        out.append(DTensor.from_local(
            got, mesh, x.placements, shape=shape,
            stride=torch.empty(shape, device="meta").stride(),
            run_check=False))
    return tuple(out)


def _permute(t, recv, send, group):
    """A collective-permute as a functional all-to-all in which a rank
    sends to at most one rank (``send``: elements a rank) and receives
    from at most one (``recv``); differentiable."""
    from torch.distributed._functional_collectives import (
        all_to_all_single_autograd)
    return all_to_all_single_autograd(t, recv, send, group)


def _to(x, pl):
    """``x`` redistributed to the placements ``pl``; ``x`` itself when it
    has them (a redistribution would reduce its gradient's partial sums
    on its own, where two uses of ``x`` can share one reduction)."""
    return x if tuple(x.placements) == tuple(pl) else \
        x.redistribute(x.device_mesh, pl)


def act_pspec(*axes: str | None) -> PartitionSpec:
    if _CTX.rules is None:
        return PartitionSpec()
    return logical_to_pspec(tuple(axes), _CTX.rules)
