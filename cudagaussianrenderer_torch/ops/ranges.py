"""Per-tile list ranges — stage E, on kernel K1 (edges).

The reference launches one thread per sorted pair and scatters range
boundaries on key changes (evaluateTileRangesKernel,
GaussianRender.cu:857-906).  The JAX package computes the same edges as a
cumulative tile histogram on the MXU (``_hist_kernel``).  The port's
kernel (csrc/edges.cu) uses the order of the sorted keys instead: a scan
that compares neighbouring keys and writes edge i for every probe between
the bins of keys i-1 and i (one read of the keys, no atomics, no scan of
counts).

That needs sorted keys.  A band-segmented list
(ops.banded.sort_pairs_banded) is sorted within each of its G segments
only, so for it the kernel runs in its segmented mode: every segment is
a list of its own, with its own row of edges.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import RenderConfig
from ..utils import cuda_build as cb
from .binning import DEPTH_BITS_PACKED
from .geometry import as_u32_i64


def _edges_torch(
    keys: torch.Tensor, num_probes: int, shift: int, segments: int = 1
) -> torch.Tensor:
    """Plain PyTorch version of K1 (see tile_edges): per segment, a
    histogram of the clamped bins and its exclusive cumsum.  Needs no sort
    order."""
    seg = keys.shape[0] // segments
    bins = torch.clamp(as_u32_i64(keys) >> shift, max=num_probes - 1)
    bins = bins + (torch.arange(keys.shape[0], device=keys.device) // seg) * num_probes
    counts = torch.bincount(bins, minlength=segments * num_probes).view(segments, num_probes)
    edges = torch.cumsum(counts[:, : num_probes - 1], 1)
    edges = torch.cat([counts.new_zeros(segments, 1), edges], 1).to(torch.int32)
    return edges[0] if segments == 1 else edges


def tile_edges(
    keys: torch.Tensor, num_probes: int, shift: int, segments: int = 1
) -> torch.Tensor:
    """K1: ``edges[t]`` = #keys whose unsigned ``key >> shift`` is < t,
    for t in [0, num_probes).

    keys: [C] int32 bit patterns of uint32 keys, SORTED ascending as
    unsigned values (the kernel detects bin boundaries between neighbours).
    Keys whose bin is num_probes - 1 or more never count, so sentinel keys
    drop out.  Returns [num_probes] int32.

    With ``segments`` = G > 1 the keys are G runs of C / G keys, each run
    sorted on its own (a band-segmented list); the result is
    [G, num_probes], row s counting the keys of run s alone.
    Replaces ops/ranges.py:_hist_kernel / _edges_pallas of the JAX package.
    """
    if num_probes < 1:
        raise ValueError("num_probes must be >= 1")
    n = keys.shape[0]
    if segments < 1 or n % segments:
        raise ValueError(f"{n} keys do not split into {segments} equal segments")
    if cb.dispatch_device(keys) == "cpu":
        return _edges_torch(keys, num_probes, shift, segments)
    dev = keys.device
    cb.require(keys, "keys", torch.int32, dev, (n,))
    edges = torch.empty((segments, num_probes), dtype=torch.int32, device=dev)
    fn = cb.kernel("edges", "gsr_edges", [cb.P, cb.I64, cb.I32, cb.I32, cb.I32, cb.P, cb.P])
    code = fn(keys.data_ptr(), n // segments, segments, shift, num_probes, edges.data_ptr(),
              cb.stream_handle(keys))
    cb.check("edges", code)
    tile_edges.launches += 1
    return edges[0] if segments == 1 else edges


tile_edges.launches = 0


def tile_ranges(
    sorted_keys: Tuple[torch.Tensor, ...],
    config: RenderConfig,
    *,
    band_rows: Optional[torch.Tensor] = None,
    band_capacity: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compute (starts [T], counts [T]) int32 for all T tiles from the
    sorted key words of sorting.sort_pairs (the packed key, or
    (tile, depth)).

    ``band_rows`` ([G + 1] int32 tile-row boundaries) and ``band_capacity``
    are for band-major lists (ops.banded.build_tile_pairs_banded +
    sort_pairs_banded): band g's pairs start at slot g * band_capacity,
    hold only tiles of rows [band_rows[g], band_rows[g + 1]) and are sorted
    within the segment, with its sentinel run before the next band.  So a
    tile of band g starts at g * band_capacity plus the number of keys of
    segment g below it, and the next edge of that segment ends it.
    """
    t = config.total_tiles
    shift = DEPTH_BITS_PACKED if len(sorted_keys) == 1 else 0
    if band_rows is None:
        edges = tile_edges(sorted_keys[0], t + 1, shift)
        return edges[:-1], edges[1:] - edges[:-1]

    g_bands = band_rows.shape[0] - 1
    if band_capacity * g_bands != sorted_keys[0].shape[0]:
        raise ValueError(
            f"{g_bands} bands of {band_capacity} slots do not make up the "
            f"{sorted_keys[0].shape[0]}-slot list"
        )
    edges = tile_edges(sorted_keys[0], t + 1, shift, segments=g_bands).view(g_bands, t + 1)
    tile = torch.arange(t, device=edges.device)
    # The band of each tile: the first whose upper row bound lies above it.
    band = torch.searchsorted(
        band_rows[1:].contiguous(), (tile // config.tiles_x).to(band_rows.dtype), right=True
    )
    band = torch.clamp(band, max=g_bands - 1)
    lo = edges[band, tile]
    starts = band.to(torch.int32) * band_capacity + lo
    return starts, edges[band, tile + 1] - lo
