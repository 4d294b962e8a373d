"""Tile-list sort — stage D of the frame pipeline.

The reference sorts (key, splat-index) pairs with cub::DeviceRadixSort
(sortTileList, GaussianRender.cu:804-855); the JAX package leaves its
variadic sort to XLA.  The port sorts ONE int64 key with ``torch.sort``
and gathers the values and the three attribute words by the returned
permutation.  For the packed key the int64 is the uint32 key; for
``depth_bits=32`` it is ``tile << 32 | depth << 8``, which orders exactly
like the lexicographic (tile, depth) pair, sentinels included (tiles are
at most 255 * 255).  Invalid entries carry sentinel keys and land in a
dead suffix that the ranges stage never addresses.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .binning import TilePairs
from .geometry import as_i32, as_u32_i64


def sort_pairs(
    pairs: TilePairs, *, with_values: bool = False, stable: bool = False
) -> Tuple[Tuple[torch.Tensor, ...], Optional[torch.Tensor], Tuple[torch.Tensor, ...]]:
    """Sort the pair list by (tile asc, depth front-to-back).

    Returns (sorted key words, sorted values or None, sorted attr words).
    ``with_values`` also carries the splat indices and forces a stable
    sort; ``stable`` keeps emission order among equal keys.
    """
    if len(pairs.keys) == 1:
        key = as_u32_i64(pairs.keys[0])
    else:
        key = (as_u32_i64(pairs.keys[0]) << 32) | as_u32_i64(pairs.keys[1])
    sorted_key, perm = torch.sort(key, stable=stable or with_values)
    if len(pairs.keys) == 1:
        keys = (as_i32(sorted_key),)
    else:
        keys = (as_i32(sorted_key >> 32), as_i32(sorted_key & 0xFFFFFFFF))
    values = pairs.values[perm] if with_values else None
    attrs = tuple(a[perm] for a in pairs.attrs)
    return keys, values, attrs
