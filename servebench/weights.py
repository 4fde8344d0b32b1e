"""Weights made from the run's seed, on the device, in the type they are
served in: one flat buffer drawn in one call from a generator seeded with
``--seed``, each leaf of the reference's ``layout`` a view of it, scaled
in place. The same seed on the same device gives the same weights, so the
reference makes them again after the program is freed instead of reading
anything the program holds."""
from __future__ import annotations

import math

import torch


def make(layout, seed: int, device, dtype=torch.bfloat16) -> dict:
    """{path: tensor} for ``layout`` (``(path, shape, kind, scale)``)."""
    sizes = [math.prod(shape) for _p, shape, _k, _s in layout]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.empty(sum(sizes), dtype=dtype, device=device)
    flat.normal_(generator=gen)
    out, off = {}, 0
    for (path, shape, _kind, scale), n in zip(layout, sizes):
        out[path] = flat[off:off + n].view(shape).mul_(scale)
        off += n
    return out


def tree(flat: dict) -> dict:
    """The nested parameter tree the program takes (``stages.0.b0.attn.wq``
    -> ``tree["stages"][0]["b0"]["attn"]["wq"]``); lists where a part is a
    number."""
    root: dict = {}
    for path, t in flat.items():
        parts = path.split(".")
        node = root
        for part, nxt in zip(parts[:-1], parts[1:]):
            key = int(part) if part.isdigit() else part
            if isinstance(node, list):
                while len(node) <= key:
                    node.append(None)
                if node[key] is None:
                    node[key] = [] if nxt.isdigit() else {}
                node = node[key]
            else:
                node = node.setdefault(key, [] if nxt.isdigit() else {})
        leaf = parts[-1]
        node[int(leaf) if leaf.isdigit() else leaf] = t
    return root
