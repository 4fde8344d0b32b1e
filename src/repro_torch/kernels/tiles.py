"""Host plan of the prefill kernels' query tiles (``csrc/prefill_wgmma.cuh``).

Both prefill kernels (the chunk route of ``prefill_attention`` and
``paged_prefill_attention``) give a block up to ``ROWS`` query rows of one
(sequence, kv head): ``BQ`` consecutive queries of the chunk times the G
query heads that share the kv head, so every K/V tile the block stages
serves all of them. Query ``i`` of a tile late in a chunk sees more keys
than one early in it (causal), so the kernels launch the tiles in reverse:
the longest walks start first (``block_coords``, the kernels' own map from
a block's rank to its tile). The plan is pure Python on host integers.
"""
from __future__ import annotations

ROWS = 128     # query rows a block owns: two warpgroups of wgmma's 64
KEYS = 128     # keys per K/V tile of the walk (``KN`` in the header)


def plan(Sq: int, G: int) -> tuple[int, int]:
    """``(BQ, n_tiles)`` for a chunk of ``Sq`` queries with ``G`` query
    heads per kv head: ``BQ`` queries a block (``BQ * G <= ROWS`` rows) and
    ``n_tiles`` tiles covering the chunk."""
    if Sq < 1 or not 1 <= G <= ROWS:
        raise ValueError(f"tile plan: Sq={Sq}, G={G}")
    bq = min(ROWS // G, Sq)
    return bq, -(-Sq // bq)


def block_coords(rank: int, n_tiles: int, B: int,
                 KV: int) -> tuple[int, int, int]:
    """``(tile, sequence, kv head)`` of the block of launch rank ``rank``
    in a grid of ``n_tiles * B * KV`` blocks: the kernels' ``block_coords``
    (``csrc/prefill_wgmma.cuh``), which hands out the chunk's last tile
    first."""
    return n_tiles - 1 - rank // (KV * B), (rank // KV) % B, rank % KV
