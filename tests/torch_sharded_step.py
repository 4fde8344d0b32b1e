"""The sharded step run for real: four gloo processes on the CPU, a
(2, 2) mesh of (data, model), the dry-run's routes and the training
rules, against the same step on plain tensors in one process.

Run by tests/test_torch_dryrun_families.py as a script (the processes are
spawned from this file):

    PYTHONPATH=src python tests/torch_sharded_step.py ARCH [ARCH ...]

It prints one JSON line: per arch the loss of both sides and, per
parameter leaf, the gradient's largest error against the plain one and
the plain gradient's largest magnitude; and whether ``sharding.halves``
moved every piece where it belongs, forward and backward, on a 1-D and a
2-D mesh. f32 throughout; every q and k projection scaled by 0.1,
so that the attention logits are not near one-hot and rounding is not
amplified (ROADMAP §3: the reference's init)."""
import dataclasses
import json
import os
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
B, S = 4, 8


def _state(arch):
    from repro_torch.configs import get_reduced
    from repro_torch.train.loop import make_train_state
    cfg = dataclasses.replace(get_reduced(arch), dtype=torch.float32)
    state = make_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    for key in ("stages", "enc_stages"):
        for stage in state.params.get(key, ()):
            for blk in stage.values():
                for sub in ("attn", "cross"):
                    for k in ("wq", "wk"):
                        if k in blk.get(sub, {}):
                            blk[sub][k].mul_(0.1)
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                              dtype=torch.int32) for k in ("tokens", "labels")}
    if cfg.is_encoder_decoder:
        batch["enc_frames"] = torch.randn(B, cfg.encoder_seq, cfg.d_model,
                                          generator=g)
    return cfg, state, batch


def _grads(cfg, params, batch, **routes):
    from repro_torch.models.params import tree_map
    from repro_torch.models.sharding import settle
    from repro_torch.train.loop import loss_fn
    from repro_torch.train.optimizer import leaves
    live = tree_map(lambda p: p.detach().requires_grad_(), params,
                    is_leaf=torch.is_tensor)
    total, (loss, _) = loss_fn(live, cfg, batch, remat=True, **routes)
    grads = torch.autograd.grad(total, leaves(live))
    return loss.detach(), settle(grads, leaves(live))


def _halves_ok(world):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.models.sharding import halves, use_rules
    ok = True
    for shape, pl in (((world,), (Shard(2),)),
                      ((2, world // 2), (Shard(0), Shard(2)))):
        mesh = DeviceMesh("cpu", torch.arange(world).view(shape))
        x = torch.arange(4 * 3 * 16, dtype=torch.float32).view(4, 3, 16)
        xd = distribute_tensor(x, mesh, pl).requires_grad_()
        with use_rules({}, mesh):
            a, b = halves(xd)
        g = torch.Generator().manual_seed(0)
        wa, wb = torch.randn(4, 3, 8, generator=g), torch.randn(
            4, 3, 8, generator=g)
        ((a * distribute_tensor(wa, mesh, pl)).sum() +
         (b * distribute_tensor(wb, mesh, pl)).sum()).backward()
        ok &= a.placements == xd.placements
        ok &= torch.equal(a.full_tensor(), x[..., :8])
        ok &= torch.equal(b.full_tensor(), x[..., 8:])
        ok &= torch.equal(xd.grad.full_tensor(), torch.cat([wa, wb], -1))
    return bool(ok)


def _worker(rank, port, archs, queue):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.dryrun import DRYRUN_ROUTES
    from repro_torch.launch.mesh import make_rules
    from repro_torch.models import transformer as T
    from repro_torch.models.params import (logical_to_pspec, param_pspecs,
                                           placements)
    from repro_torch.models.sharding import use_rules
    out = {"halves": _halves_ok(WORLD)}
    mesh = DeviceMesh("cpu", torch.arange(WORLD).view(2, WORLD // 2),
                      mesh_dim_names=("data", "model"))
    rules = make_rules("train")
    # the recurrence runs every step: "once" counts, it does not compute
    routes = dict(DRYRUN_ROUTES, scan="loop")
    for arch in archs:
        cfg, state, batch = _state(arch)

        def shard(tree, spec):
            if torch.is_tensor(tree):
                return distribute_tensor(tree, mesh, placements(spec, mesh))
            if isinstance(tree, dict):
                return {k: shard(v, spec[k]) for k, v in tree.items()}
            return type(tree)(shard(v, s) for v, s in zip(tree, spec))
        params = shard(state.params, param_pspecs(T.model_decls(cfg), rules))
        on_mesh = {k: distribute_tensor(v, mesh, placements(
            logical_to_pspec(("batch", "seq", None)[:v.ndim], rules), mesh))
            for k, v in batch.items()}
        with use_rules(rules, mesh):
            loss, grads = _grads(cfg, params, on_mesh, **routes)
        out[arch] = (float(loss.full_tensor()),
                     [g.full_tensor().numpy() for g in grads])
    if rank == 0:
        queue.put(out)
    dist.barrier()
    dist.destroy_process_group()


def main(archs):
    from repro_torch.train.optimizer import leaves
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    procs = [ctx.Process(target=_worker, args=(r, port, archs, queue))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    got = queue.get()
    for p in procs:
        p.join(60)
    report = {"halves": got.pop("halves")}
    for arch in archs:
        cfg, state, batch = _state(arch)
        loss, want = _grads(cfg, state.params, batch, fuse_qkv=False)
        sharded_loss, grads = got[arch]
        report[arch] = {
            "loss": [sharded_loss, float(loss)],
            "leaves": [[float(abs(torch.from_numpy(g) - w).max()),
                        float(w.abs().max())] for g, w in zip(grads, want)]}
        assert len(grads) == len(leaves(state.params))
    print(json.dumps(report))


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    main(sys.argv[1:])
