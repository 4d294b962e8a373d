"""Per-tile list ranges — stage E, on kernel K1 (edges).

The reference launches one thread per sorted pair and scatters range
boundaries on key changes (evaluateTileRangesKernel,
GaussianRender.cu:857-906).  The JAX package computes the same edges as a
cumulative tile histogram on the MXU (``_hist_kernel``).  The port's
kernel (csrc/edges.cu) goes back to boundary detection: with the keys
sorted, thread i compares key i-1 and key i and writes edge i for every
probe between their bins — one read of the keys, no atomics, no scan.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import RenderConfig
from ..utils import cuda_build as cb
from .binning import DEPTH_BITS_PACKED
from .geometry import as_u32_i64


def _edges_torch(keys: torch.Tensor, num_probes: int, shift: int) -> torch.Tensor:
    """Plain PyTorch version of K1 (see tile_edges): a histogram of the
    clamped bins and its exclusive cumsum.  Needs no sort order."""
    bins = torch.clamp(as_u32_i64(keys) >> shift, max=num_probes - 1)
    counts = torch.bincount(bins, minlength=num_probes)
    edges = torch.cumsum(counts[: num_probes - 1], 0)
    return torch.cat([torch.zeros_like(edges[:1]), edges]).to(torch.int32)


def tile_edges(keys: torch.Tensor, num_probes: int, shift: int) -> torch.Tensor:
    """K1: ``edges[t]`` = #keys whose unsigned ``key >> shift`` is < t,
    for t in [0, num_probes).

    keys: [C] int32 bit patterns of uint32 keys, SORTED ascending as
    unsigned values (the kernel detects bin boundaries between neighbours).
    Keys whose bin is num_probes - 1 or more never count, so sentinel keys
    drop out.  Returns [num_probes] int32.
    Replaces ops/ranges.py:_hist_kernel / _edges_pallas of the JAX package.
    """
    if num_probes < 1:
        raise ValueError("num_probes must be >= 1")
    if cb.dispatch_device(keys) == "cpu":
        return _edges_torch(keys, num_probes, shift)
    dev = keys.device
    cb.require(keys, "keys", torch.int32, dev, (keys.shape[0],))
    edges = torch.empty(num_probes, dtype=torch.int32, device=dev)
    fn = cb.kernel("edges", "gsr_edges", [cb.P, cb.I64, cb.I32, cb.I32, cb.P, cb.P])
    code = fn(keys.data_ptr(), keys.shape[0], shift, num_probes, edges.data_ptr(),
              cb.stream_handle(keys))
    cb.check("edges", code)
    tile_edges.launches += 1
    return edges


tile_edges.launches = 0


def tile_ranges(
    sorted_keys: Tuple[torch.Tensor, ...], config: RenderConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compute (starts [T], counts [T]) int32 for all T tiles from the
    sorted key words of sorting.sort_pairs (the packed key, or
    (tile, depth)); the flat path of the JAX package's tile_ranges."""
    t = config.total_tiles
    shift = DEPTH_BITS_PACKED if len(sorted_keys) == 1 else 0
    edges = tile_edges(sorted_keys[0], t + 1, shift)
    return edges[:-1], edges[1:] - edges[:-1]
