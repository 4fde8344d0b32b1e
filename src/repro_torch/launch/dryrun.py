"""Multi-pod dry-run: run every (architecture x input shape) step on the
production meshes, simulated, and record memory, FLOPs and collectives.

The mesh is a ``DeviceMesh`` over a fake process group (``launch/mesh.py``)
and every tensor is a ``DTensor`` whose local shard lives on the meta
device: the step runs op by op as rank 0 would run it, DTensor inserting
the collectives its placements need, and nothing is allocated or moved.
So this needs no card and runs on none, by design, as the reference's
dry-run lowers on forced host CPU devices. The model takes the
reference's non-kernel branches (``causal_impl="mha"``), as the
reference's does with its flash kernel off, and the routes
``DRYRUN_ROUTES`` names.

The record has the reference's keys. Where the reference reads XLA's
compiled module, this reads the step it ran:
  * ``memory.argument_bytes`` / ``output_bytes``: rank 0's local shard
    bytes of the step's inputs and outputs;
  * ``memory.temp_bytes``, ``generated_code_bytes``, ``compile_s`` and
    ``bytes_accessed``: null, since no compiler runs;
  * ``lower_s``: the wall time of building the inputs and running the
    step;
  * ``flops``: per device, the FLOPs of the local products rank 0 runs
    (``torch.utils.flop_counter``'s formulas: matmuls, convolutions,
    attention), backward and recompute included; elementwise ops are not
    counted (XLA's cost analysis counts them);
  * ``collectives``: per kind, the functional collectives rank 0 issues,
    their count and their outputs' bytes (what the reference reads from
    each collective's result shape in the HLO).
An xLSTM recurrence runs three steps (``scan="once"``), the middle one's
collectives and FLOPs, forward and backward, counted once a middle token
(``sharding.trips``), as the reference multiplies a While body's by its
trip count.

MUST be run as its own process: the fake process group is process-global
and is initialised once, at the first mesh's size.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-27b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list   # all pairs
Results land in experiments/dryrun/<arch>__<shape>__<mesh>.json.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.configs import ALIASES, get_config
from repro_torch.launch.mesh import (flat_pod_view, make_production_mesh,
                                     make_rules)
from repro_torch.models import transformer as T
from repro_torch.models.config import pad_for_tp
from repro_torch.models.params import (PartitionSpec, abstract_params,
                                       distribute_abstract, logical_to_pspec,
                                       param_count, param_pspecs,
                                       tree_leaves)
from repro_torch.models.sharding import reset_trips, trips, use_rules
from repro_torch.train.loop import (TrainState, abstract_train_state,
                                    train_step)
from repro_torch.train.optimizer import AdamWState

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1, long=True),
}

# long_500k runs only where attention state is sub-quadratic / bounded
# (see DESIGN.md §Shape skips); whisper's decode ctx is architecture-bounded.
LONG_OK = {"jamba-1.5-large-398b", "xlstm-125m", "gemma3-27b"}

TP = 16  # model-axis degree on both meshes

# the forward's routes the dry-run takes (serving and training take the
# defaults): q, k and v as three products (a cat of head-sharded weights
# would gather them), the reference's one-hot MoE dispatch, and each
# xLSTM recurrence as its first and last steps and one middle step
# counted once a middle token (the reference's While loop, whose
# collectives its count multiplies by the trip count)
DRYRUN_ROUTES = dict(fuse_qkv=False, moe_dispatch="onehot", scan="once")


def runnable_pairs():
    pairs = []
    for arch in ALIASES:
        for shape in SHAPES:
            if shape == "long_500k" and arch not in LONG_OK:
                continue
            pairs.append((arch, shape))
    return pairs


# ---------------------------------------------------------------------------
def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg, kind: str, seq: int, batch: int):
    """Meta tensors + logical axes for every model input."""
    i32 = torch.int32
    specs, axes = {}, {}
    if kind in ("train", "prefill"):
        specs["tokens"] = _meta((batch, seq), i32)
        axes["tokens"] = ("batch", "seq")
        if kind == "train":
            specs["labels"] = _meta((batch, seq), i32)
            axes["labels"] = ("batch", "seq")
        if cfg.arch_type == "vlm":
            specs["mm_embeds"] = _meta((batch, cfg.mm_tokens, cfg.d_model),
                                       cfg.dtype)
            axes["mm_embeds"] = ("batch", None, "embed_act")
            specs["positions"] = _meta((batch, seq, 3), i32)
            axes["positions"] = ("batch", "seq", None)
        if cfg.is_encoder_decoder:
            specs["enc_frames"] = _meta((batch, cfg.encoder_seq,
                                         cfg.d_model), cfg.dtype)
            axes["enc_frames"] = ("batch", None, "embed_act")
    else:  # decode: ONE new token against a seq-length KV cache
        specs["tokens"] = _meta((batch, 1), i32)
        axes["tokens"] = ("batch", "seq")
        pos_shape = (batch, 1, 3) if cfg.arch_type == "vlm" else (batch, 1)
        specs["positions"] = _meta(pos_shape, i32)
        axes["positions"] = ("batch", "seq", None)[: len(pos_shape)]
    return specs, axes


def input_specs(arch: str, shape: str, opts: frozenset = frozenset()):
    """Public helper: (cfg, shape meta, abstract inputs, their axes)."""
    cfg = get_config(arch)
    if "seq_par_repl" not in opts:
        # heads/vocab padding is only needed when those dims are TP-sharded
        cfg = pad_for_tp(cfg, TP)
    meta = SHAPES[shape]
    specs, axes = batch_specs(cfg, meta["kind"], meta["seq"], meta["batch"])
    return cfg, meta, specs, axes


# ---------------------------------------------------------------------------
def build(arch: str, shape: str, mesh, rules, opts=frozenset(), *,
          cfg=None, meta=None):
    """(cfg, step, args): the step's inputs as meta ``DTensor``s on
    ``mesh``, sharded by ``rules``; ``step(*args)`` runs it. ``cfg`` and
    ``meta`` (a ``SHAPES`` entry) override the pair's, for reduced
    runs."""
    if cfg is None:
        cfg, meta, specs, axes = input_specs(arch, shape, opts)
    else:
        specs, axes = batch_specs(cfg, meta["kind"], meta["seq"],
                                  meta["batch"])
    kind = meta["kind"]
    kv_dtype = torch.int8 if "kv_int8" in opts else torch.bfloat16
    batch = distribute_abstract(
        specs, {k: logical_to_pspec(tuple(axes[k]), rules) for k in specs},
        mesh)
    decls = T.model_decls(cfg)
    p_specs = param_pspecs(decls, rules)

    if kind == "train":
        state = abstract_train_state(cfg)
        params = distribute_abstract(state.params, p_specs, mesh)
        mu = distribute_abstract(state.opt.mu, p_specs, mesh)
        nu = distribute_abstract(state.opt.nu, p_specs, mesh)
        step = distribute_abstract(state.opt.step, PartitionSpec(), mesh)

        def fn(st, b):
            return train_step(st, b, cfg, remat=True, **DRYRUN_ROUTES)

        return cfg, fn, (TrainState(params, AdamWState(step, mu, nu)), batch)

    params = distribute_abstract(abstract_params(decls), p_specs, mesh)
    cache_len = meta["seq"]
    cdecls = {"stages": T.cache_decls(
        cfg, meta["batch"], cache_len, dtype=kv_dtype,
        window_cache="window_cache" in opts)["stages"]}
    cache = distribute_abstract(abstract_params(cdecls),
                                param_pspecs(cdecls, rules), mesh)
    # the write offset is a host integer in the port's forward: a decode
    # writes its token at the end of the seq-length cache
    cache["idx"] = torch.tensor(cache_len - 1 if kind == "decode" else 0,
                                dtype=torch.int32)

    if kind == "prefill":
        def fn(p, cache, b):
            logits, new_cache, _ = T.forward(
                T.cast_params(p, cfg.dtype), cfg, b["tokens"],
                positions=b.get("positions"), mm_embeds=b.get("mm_embeds"),
                enc_frames=b.get("enc_frames"), cache=cache, q_start=0,
                last_only=True, causal_impl="mha", **DRYRUN_ROUTES)
            return logits, new_cache
    else:
        def fn(p, cache, b):
            logits, new_cache, _ = T.forward(
                T.cast_params(p, cfg.dtype), cfg, b["tokens"],
                positions=b["positions"], cache=cache, causal_impl="mha",
                **DRYRUN_ROUTES)
            return logits, new_cache

    return cfg, fn, (params, cache, batch)


# ---------------------------------------------------------------------------
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
# an all-to-all in which a rank sends to at most one rank and receives
# from at most one is a collective-permute (``sharding.halves``)
PERMUTE = "collective-permute"
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional")
_NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd"}


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local_bytes(tree) -> int:
    """Rank 0's bytes of a tensor tree: each ``DTensor``'s local shard,
    each plain tensor whole."""
    total = 0
    for t in tree_leaves(tree, is_leaf=torch.is_tensor):
        if not torch.is_tensor(t):
            continue
        loc = t.to_local() if _is_dtensor(t) else t
        total += loc.numel() * loc.element_size()
    return total


def _is_permute(args) -> bool:
    """An ``all_to_all_single(input, output_split_sizes,
    input_split_sizes, group)`` that pairs this rank with at most one
    sender and one receiver."""
    recv, send = args[1], args[2]
    return recv is not None and send is not None and \
        sum(1 for c in recv if c) <= 1 and sum(1 for c in send if c) <= 1


def _step_counter():
    """A ``TorchDispatchMode`` that sees the local ops DTensor issues
    (collectives included) and counts the collectives and FLOPs of
    rank 0."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class StepCounter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.collectives: dict[str, dict] = {}
            self.flops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if isinstance(func, torch._ops.HigherOrderOperator) or \
                    any(issubclass(t, FakeTensor) for t in types):
                # fake tensors: DTensor inferring an op's global output
                # shape, which no rank runs
                return func(*args, **kwargs)
            if any(issubclass(t, DTensor) for t in types):
                # let DTensor desugar the op into local ops (and the
                # collectives its placements need); they come back here
                return NotImplemented
            out = func(*args, **kwargs)
            packet = func._overloadpacket
            if func.namespace in _COLLECTIVE_NAMESPACES:
                name = packet.__name__
                if name not in _NOT_COLLECTIVES:
                    kind = COLLECTIVE_KINDS.get(name, name)
                    if kind == "all-to-all" and _is_permute(args):
                        kind = PERMUTE
                    rec = self.collectives.setdefault(
                        kind, {"count": 0, "bytes": 0})
                    n = trips()
                    rec["count"] += n
                    rec["bytes"] += n * local_bytes(out)
            elif packet in flop_registry:
                self.flops += trips() * int(flop_registry[packet](
                    *args, **kwargs, out_val=out))
            return out

    return StepCounter()


def run_step(fn, args):
    """Run ``fn(*args)`` under the counter: (outputs, collectives, flops)."""
    counter = _step_counter()
    reset_trips()
    try:
        with counter:
            out = fn(*args)
    finally:
        reset_trips()
    return out, counter.collectives, counter.flops


def run_one(arch: str, shape: str, mesh_kind: str, outdir: str,
            opts: frozenset = frozenset(), *, cfg=None, meta=None,
            write: bool = True) -> dict:
    multi = mesh_kind == "multi"
    meta = meta or SHAPES[shape]
    mode = ("train" if meta["kind"] == "train"
            else ("long_ctx" if meta.get("long") else "serve"))
    mesh = make_production_mesh(multi_pod=multi)
    rules = make_rules(mode, multi_pod=multi, opts=opts)
    layout, layout_rules = flat_pod_view(mesh, rules)

    t0 = time.time()
    with use_rules(layout_rules, layout):
        cfg, fn, args = build(arch, shape, layout, layout_rules, opts,
                              cfg=cfg, meta=meta)
        arg_bytes = local_bytes(args)
        out, coll, flops = run_step(fn, args)
        out_bytes = local_bytes(out)
    t_lower = time.time() - t0

    n_dev = mesh.size()
    from repro_torch.launch.analysis import analytic_costs, roofline_terms
    costs = analytic_costs(cfg, meta["kind"], meta["seq"], meta["batch"],
                           kv_dtype_bytes=1 if "kv_int8" in opts else 2,
                           window_cache="window_cache" in opts)
    coll_total = sum(v["bytes"] for v in coll.values())
    terms = roofline_terms(costs, coll_total, n_dev)
    result = {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "devices": int(n_dev),
        "mode": mode, "opts": sorted(opts),
        "params": param_count(T.model_decls(cfg)),
        "padded_heads": cfg.num_heads, "orig_heads": cfg.orig_num_heads or cfg.num_heads,
        "padded_kv": cfg.num_kv_heads, "orig_kv": cfg.orig_num_kv_heads or cfg.num_kv_heads,
        "lower_s": round(t_lower, 1), "compile_s": None,
        "flops": float(flops),
        "bytes_accessed": None,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": None,
            "generated_code_bytes": None,
        },
        "collectives": coll,
        "analytic": {
            "flops_global": costs.flops,
            "hbm_bytes_global": costs.hbm_bytes,
            "model_flops": costs.model_flops,
            "kv_cache_bytes_global": costs.kv_cache_bytes,
        },
        "roofline": terms,
    }
    tag = ("__" + "+".join(sorted(opts))) if opts else ""
    if write:
        os.makedirs(outdir, exist_ok=True)
        path = os.path.join(outdir, f"{arch}__{shape}__{mesh_kind}{tag}.json")
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
    print(f"[dryrun] {arch} x {shape} x {mesh_kind}{tag}: "
          f"step={t_lower:.1f}s flops={result['flops']:.3e} "
          f"colls={ {k: v['count'] for k, v in coll.items()} }")
    print(f"  memory: { {k: v for k, v in result['memory'].items()} }")
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--opts", default="",
                    help="comma list: moe_data,seq_par,act_model,kv_int8,window_cache")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args()
    if args.list:
        for a, s in runnable_pairs():
            print(a, s)
        return
    opts = frozenset(o for o in args.opts.split(",") if o)
    run_one(args.arch, args.shape, args.mesh, args.out, opts)


if __name__ == "__main__":
    main()
