"""Production mesh + logical-axis rule construction.

The mesh shapes are the reference's: single pod = 16x16 = 256 devices
(data, model); multi-pod = 2 x 16 x 16 = 512 devices (pod, data, model).
The mesh is simulated: one process stands as rank 0 of a ``"fake"``
process group (``torch.testing``'s ``FakeStore``), and the dry-run's
tensors live on the meta device. So the dry-run needs no card and runs
on no card, by design, as the reference's runs on forced host CPU
devices; a collective issued on it moves no byte and is only counted.
Function (not module constant) so importing never touches
``torch.distributed``.
"""
from __future__ import annotations

import torch


def init_fake_group(world_size: int) -> None:
    """Make this process rank 0 of a fake process group of
    ``world_size`` ranks, once a process; a later call asks for no more
    ranks than the group has."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() < world_size:
            raise RuntimeError(
                f"the fake process group has {dist.get_world_size()} ranks, "
                f"{world_size} asked for: initialise it with the largest "
                "mesh first")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False):
    from torch.distributed.device_mesh import DeviceMesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    init_fake_group(n)
    # a "cpu" mesh: DTensor's shape inference then fakes CPU tensors, which
    # any host can; it also moves a tensor from one sharded dim to another
    # by all-gather + local chunk there (gloo has no all-to-all)
    return DeviceMesh("cpu", torch.arange(n).view(shape),
                      mesh_dim_names=axes)


def flat_pod_view(mesh, rules: dict):
    """(mesh, rules) the dry-run lays its tensors out with: the multi-pod
    mesh as a 2-D (pod x data, model) mesh over the same ranks (pod major)
    and its rules with each ("pod", "data") entry naming that one dim;
    any other mesh and its rules as they are. The rules name pod only
    together with data, so the view shards every tensor as the 3-D mesh
    does. DTensor plans a redistribution on a 3-D mesh by a graph search
    over its candidates (minutes a step here), on a 2-D one quickly."""
    from torch.distributed.device_mesh import DeviceMesh
    if mesh.mesh_dim_names != ("pod", "data", "model"):
        return mesh, rules
    pod_data = ("pod", "data")
    flat = {}
    for name, axes in rules.items():
        if axes == pod_data:
            axes = "pod_data"
        elif axes is not None and "pod" in ((axes,) if isinstance(axes, str)
                                            else axes):
            raise ValueError(f"rule {name}: {axes} names pod apart from data")
        flat[name] = axes
    view = DeviceMesh("cpu", mesh.mesh.reshape(-1, mesh.size(2)),
                      mesh_dim_names=("pod_data", "model"))
    return view, flat


def make_rules(mode: str, *, multi_pod: bool = False,
               opts: frozenset | set = frozenset()) -> dict:
    """Logical-axis -> mesh-axis rules per execution mode.

    mode: 'train' | 'serve' | 'long_ctx'
    opts (hillclimb levers, EXPERIMENTS.md §Perf):
      'moe_data'  — shard MoE dispatch/expert tensors' group dim over data
                    (baseline replicates them -> per-layer all-gather)
      'seq_par'   — sequence parallelism for prefill: activations' seq dim
                    over the model axis (attention gathers the small GQA KV)
      'act_model' — shard saved train activations' d_model over model axis
    """
    data = ("pod", "data") if multi_pod else ("data",)
    base = {
        "batch": data,
        "seq": None,
        "embed": None,
        "embed_act": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "experts": None,
        "expert_mlp": "model",
        "vocab": "model",
        "conv": None,
        "state": None,
        "inner": "model",
        "cache_seq": None,
        "layers": None,
        "moe_group": None,
    }
    if mode == "train":
        # FSDP(ZeRO-3-style): params sharded along d_model over the data axis
        base["embed"] = data if multi_pod else "data"
    elif mode == "long_ctx":
        # batch=1: context parallelism — KV cache seq dim over the data axis
        base["batch"] = None
        base["cache_seq"] = data if multi_pod else "data"
    elif mode != "serve":
        raise ValueError(mode)
    if "moe_data" in opts:
        base["moe_group"] = data if multi_pod else "data"
    if "seq_par" in opts:
        base["seq"] = "model"
    if "seq_par_repl" in opts:
        # small-model long-prefill recipe: replicate weights (fits HBM),
        # use the model axis purely for sequence parallelism -> MLP fully
        # local; attention all-gathers only the small GQA KV
        base["seq"] = "model"
        for ax in ("heads", "kv_heads", "mlp", "vocab", "embed", "inner",
                   "expert_mlp"):
            base[ax] = None
    if "act_model" in opts:
        base["embed_act"] = "model"
    return base
