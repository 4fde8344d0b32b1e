"""Train state and train step: the JAX package's loss over the cache-less
forward, with the same mixed precision (f32 masters cast to
``cfg.dtype`` inside the differentiated function), attention through
``layers.mha`` (no kernel has a backward) and AdamW in place."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import abstract_params, init_params, tree_map
from repro_torch.models.sharding import log_softmax, pick, whole

from .optimizer import AdamWState, adamw_init, adamw_update, cosine_lr, leaves

AUX_LOSS_COEF = 0.01


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def make_train_state(cfg: ModelConfig, gen: torch.Generator,
                     device) -> TrainState:
    """f32 master parameters drawn from ``gen`` (on its own device, as
    ``init_params`` draws), placed on ``device``; zero moments."""
    params = init_params(T.model_decls(cfg), gen, device=device)
    return TrainState(params, adamw_init(params))


def abstract_train_state(cfg: ModelConfig) -> TrainState:
    """Meta-device train state for the dry-run: parameters in their
    declared dtype, f32 moments, a () int32 step; nothing allocated."""
    params = abstract_params(T.model_decls(cfg))
    zeros = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                           device="meta"),
                     params, is_leaf=torch.is_tensor)
    step = torch.empty((), dtype=torch.int32, device="meta")
    return TrainState(params, AdamWState(step, zeros, zeros))


def loss_fn(params, cfg: ModelConfig, batch, *, remat=False, fuse_qkv=True,
            moe_dispatch="index", scan="loop"):
    """(loss + AUX_LOSS_COEF * aux, (loss, aux)): the masked mean token
    NLL from an f32 log-softmax, and the MoE load-balance loss. The f32
    masters are cast to ``cfg.dtype`` here, inside the graph, so the
    gradients flow through the cast into the masters, as in the JAX
    package's forward. ``remat``, ``fuse_qkv``, ``moe_dispatch`` and
    ``scan`` go to the forward."""
    kwargs = {k: batch[k] for k in ("mm_embeds", "positions", "enc_frames")
              if k in batch}
    logits, _, aux = T.forward(T.cast_params(params, cfg.dtype), cfg,
                               batch["tokens"], causal_impl="mha",
                               remat=remat, fuse_qkv=fuse_qkv,
                               moe_dispatch=moe_dispatch, scan=scan,
                               **kwargs)
    labels = batch["labels"].long()
    # vocab-sharded logits (under sharding rules) reduce across the mesh
    nll = -pick(log_softmax(logits.to(torch.float32)), labels)
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(labels, dtype=torch.float32)
    loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss + AUX_LOSS_COEF * aux, (loss, aux)


def train_step(state: TrainState, batch, cfg: ModelConfig, *, base_lr=3e-4,
               remat=False, fuse_qkv=True, moe_dispatch="index",
               scan="loop"):
    """One step: gradients of ``loss_fn`` by ``torch.autograd.grad`` over
    the parameter leaves, ``cosine_lr(step + 1)``, ``adamw_update`` (in
    place: the returned state holds the same tensors). Metrics: loss,
    aux_loss, grad_norm, lr (device scalars). ``remat``, ``fuse_qkv``,
    ``moe_dispatch`` and ``scan`` go to ``loss_fn``."""
    # differentiate through detached aliases of the masters: the state's
    # tensors never require grad, and the update writes their storage
    live = tree_map(lambda p: p.detach().requires_grad_(), state.params,
                    is_leaf=torch.is_tensor)
    with torch.enable_grad():
        total, (loss, aux) = loss_fn(live, cfg, batch, remat=remat,
                                     fuse_qkv=fuse_qkv,
                                     moe_dispatch=moe_dispatch, scan=scan)
        grads = torch.autograd.grad(total, leaves(live))
    del live, total
    lr = cosine_lr(state.opt.step + 1, base_lr=base_lr)
    params, opt, gnorm = adamw_update(grads, state.opt, state.params, lr=lr)
    # the metrics whole (under sharding rules, all-reduced)
    metrics = {"loss": whole(loss.detach()), "aux_loss": whole(aux.detach()),
               "grad_norm": gnorm, "lr": lr}
    return TrainState(params, opt), metrics
