"""Checkpointing via numpy .npz, in the JAX package's format.

Flattens a tree (dicts, lists, NamedTuples by field name, tensor leaves)
into '/'-joined key paths; bf16, which numpy lacks, is stored as its
uint16 bits under ``BF16::<key>``. The file is written to ``<path>.tmp.npz``
and then renamed over ``path``. A checkpoint written by either package
loads in the other. Works for params-only saves too (serving weights).
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif hasattr(tree, "_fields"):  # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def save(path: str, tree) -> None:
    store = {}
    for k, t in _flatten(tree).items():
        t = torch.as_tensor(t).detach().cpu()
        if t.dtype == torch.bfloat16:
            store["BF16::" + k] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            store[k] = t.numpy()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **store)
    os.replace(tmp, path)


def _rebuild(like, flat, prefix=""):
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, f"{prefix}{k}/") for k, v in like.items()}
    if isinstance(like, (list, tuple)) and not hasattr(like, "_fields"):
        return type(like)(_rebuild(v, flat, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    if hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, k), flat, f"{prefix}{k}/")
                            for k in like._fields))
    key = prefix.rstrip("/")
    t = flat[key]
    if t.shape != like.shape:
        raise ValueError(f"checkpoint {key}: shape {tuple(t.shape)} != "
                         f"{tuple(like.shape)}")
    return t.to(device=like.device, dtype=like.dtype)


def load(path: str, like):
    """Restore into the structure of ``like``, by name, onto each leaf's
    device and dtype. Raises ``KeyError`` on a missing or extra key and
    ``ValueError`` on a shape that differs."""
    flat = {}
    with np.load(path) as data:
        for k in data.files:
            a = data[k]
            if k.startswith("BF16::"):
                flat[k[6:]] = torch.from_numpy(a.view(np.int16)).view(
                    torch.bfloat16)
            else:
                flat[k] = torch.from_numpy(a)
    ref = _flatten(like)
    if set(ref) != set(flat):
        raise KeyError(f"checkpoint keys mismatch: missing="
                       f"{sorted(set(ref) - set(flat))} extra="
                       f"{sorted(set(flat) - set(ref))}")
    return _rebuild(like, flat)
