"""Multi-device rendering over torch.distributed: one process a card.

The JAX package shards one traced program over a ``jax.sharding.Mesh``;
here every rank of a process group runs the same Python program on its
card, and the collectives are explicit:

  * SPLAT parallelism: each rank holds a contiguous 1/n slice of the
    splats and runs stages A-B (SH colours, projection) on it.
  * One all-gather brings every rank's clip data, colours and opacities
    (14 float32 rows a splat, packed into one [14, N/n] buffer) to every
    rank, tiled along the splat axis in rank order, so the gathered arrays
    are the single-device ones.
  * TILE parallelism: each rank then builds, sorts, ranges and rasterizes
    only the pairs of its band of tile rows (kernels K2 + K3 with the
    candidate rects clamped to the band, K1, K4 with the band's row
    offset), so the pair lists partition exactly across ranks and the sort
    shrinks by the rank count.
  * FRAME parallelism: on a 2-D ("frames", "tiles") mesh each frame group
    renders its share of a camera batch, tile-row sharded within it.

Bands are uniform (tiles_y / n rows each, Python ints), or, with
``config.balanced_bands``, re-chosen every frame for equal work from the
gathered clip data (_band_weights, _band_bounds; every rank computes the
same bounds).  Balanced bounds stay on the device as 0-d tensors, as the
JAX package's traced bounds: the binning clamps to them, the band's tile
ranges are gathered from them and K4 reads the band's first row from
device memory, so no host reads anything between a frame's first kernel
and its last.

Where the JAX functions return the image sharded by rows, these return the
whole frame on every rank (what ``np.asarray`` of the JAX result gives):
an all-gather of the uniform bands, or a sum over ranks of the balanced
bands placed into zeroed frames (the bands are disjoint, so the uint8 sum
is exact).

A ``Mesh`` names the axes of the ranks of the default process group; its
device is the group's: the current card under NCCL, the CPU under gloo.
``parallel.launch.spawn`` starts the ranks.  ``render_band`` runs one
rank's band of a balanced frame on one device with no process group at
all: the single-card check and measurement of this path.

``DistributedRenderer`` keeps the JAX DistributedRenderer's compiled
frame: on the card each rank replays one CUDA graph of its whole frame,
collectives included, per capacity key (render.run_graphed).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..models.camera import Camera
from ..models.scene import GaussianScene
from ..ops.binning import build_tile_pairs, splat_tile_rects
from ..ops.expand import MAX_CAPACITY as _KERNEL_MAX_CAPACITY
from ..ops.expand import PREP_BLK
from ..ops.projection import SplatClipData, project_splats
from ..ops.ranges import tile_ranges
from ..ops.raster import pack_pair_data, rasterize_tiles, tiles_to_image
from ..ops.sorting import sort_pairs
from ..ops.splat import splat_colors
from ..render import (
    CAMERA_FLOATS, camera_array, camera_tensors, camera_views, round_capacity, run_graphed,
    warn_capacity_ceiling,
)
from ..utils.device import resolve_device

# Rows of the packed per-splat buffer that one all-gather moves: the clip
# fields, three colour rows, the opacity.
CLIP_ROWS = len(SplatClipData._fields)
GATHER_ROWS = CLIP_ROWS + 4
# torch.cuda.graph's capture_error_mode for a rank's frame.  The NCCL
# process group's watchdog thread queries the events of collectives issued
# before a capture while this thread captures; under the default "global"
# mode such a call from another thread can invalidate the capture, under
# "thread_local" only this thread's calls are checked.  (On H100 cards,
# torch 2.11 and NCCL 2.28.9, both modes captured and replayed the frame
# of 1 and 4 ranks alike: the race did not show, and cannot be provoked.)
SHARDED_CAPTURE_MODE = "thread_local"


# ---------------------------------------------------------------------------
# The mesh: named axes over the ranks of the default process group
# ---------------------------------------------------------------------------


class Mesh:
    """The ranks of the default process group as a grid with named axes,
    row-major (rank = frame index * n_tiles + tile index on a 2-D mesh),
    seen from this rank: its index along each axis (``jax.lax.axis_index``),
    each axis's size (``mesh.shape[axis]``, ``psum(1, axis)``) and the
    process group of the ranks that share its other coordinates.

    Every rank of the group must build the same mesh, in the same order as
    any other group it builds.  Its ``device`` is the group's: the current
    card under NCCL, the CPU under gloo.
    """

    def __init__(self, axes: Sequence[Tuple[str, int]]):
        _require_group()
        names = tuple(name for name, _ in axes)
        sizes = tuple(int(size) for _, size in axes)
        if len(set(names)) != len(names):
            raise ValueError(f"mesh axis names must differ: {names}")
        world, rank = dist.get_world_size(), dist.get_rank()
        if int(np.prod(sizes)) != world:
            raise ValueError(f"a {'x'.join(map(str, sizes))} mesh needs {int(np.prod(sizes))} "
                             f"ranks, the process group has {world}")
        backend = str(dist.get_backend())
        if "nccl" in backend:
            self.device = torch.device("cuda", torch.cuda.current_device())
        elif "gloo" in backend:
            self.device = torch.device("cpu")
        else:
            raise ValueError(f"no device for the process group's backend {backend!r}: NCCL "
                             "serves the card, gloo the CPU")
        self.axis_names = names
        self.shape = dict(zip(names, sizes))
        grid = np.arange(world).reshape(sizes)
        coords = np.unravel_index(rank, sizes)
        self._index, self._group = {}, {}
        for a, name in enumerate(names):
            self._index[name] = int(coords[a])
            if sizes[a] == world:
                self._group[name] = dist.group.WORLD
                continue
            # new_group is collective over the whole default group: every
            # rank creates every line of this axis, in the same order.
            for line in np.moveaxis(grid, a, -1).reshape(-1, sizes[a]):
                group = dist.new_group([int(r) for r in line])
                if rank in line:
                    self._group[name] = group

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self._index[axis]

    def group(self, axis: str):
        """The process group of the ranks on this rank's line along ``axis``,
        in the order of their coordinate."""
        return self._group[axis]


def _require_group():
    if not dist.is_initialized():
        raise RuntimeError("no process group: start the ranks with parallel.launch.spawn "
                           "or call parallel.launch.init_rank first")


def make_mesh(n_devices: Optional[int] = None, axis: str = "tiles") -> Mesh:
    """A 1-D mesh over every rank of the default process group
    (``n_devices``, when given, must be their number)."""
    _require_group()
    return Mesh([(axis, n_devices or dist.get_world_size())])


def make_mesh_2d(n_frames: int, n_tiles: int,
                 axes: Tuple[str, str] = ("frames", "tiles")) -> Mesh:
    """2-D mesh: frame groups on the outer axis (no communication between
    them) by tile-row sharding on the inner axis, whose ranks are
    neighbours in rank order."""
    return Mesh([(axes[0], n_frames), (axes[1], n_tiles)])


def _gather_tiled(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``: every rank's
    ``x`` on the line along ``axis``, concatenated along ``dim`` in rank
    order.  One collective into one buffer (rank-major along dim 0), then
    a view for ``dim`` 0 or one copy for another; a CUDA graph can capture
    both.  A 1-rank line runs the collective too, as a copy."""
    n = mesh.shape[axis]
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=mesh.group(axis))
    if dim == 0:
        return out
    return out.reshape((n,) + tuple(x.shape)).movedim(0, dim).flatten(dim, dim + 1)


# ---------------------------------------------------------------------------
# Bands of tile rows
# ---------------------------------------------------------------------------


def _band_weights(clip: SplatClipData, config: RenderConfig,
                  sample_cap: int = 1 << 16) -> torch.Tensor:
    """Per-tile-row work estimate [tiles_y] float32 from the (whole) clip
    data: each splat's candidate rect adds its width to every row it
    covers, in proportion to the pairs that row will emit.  Splats are
    subsampled to ``sample_cap`` (a balance needs ~1%, not exactness);
    culled splats have zero-width rects.  The JAX package's f32 sums of
    integer widths: exact while a row's sum stays under 2^24, which the
    subsample ensures (65,536 splats x 255 tiles)."""
    n = clip.cx.shape[-1]
    stride = max(1, n // sample_cap)
    rects = splat_tile_rects(SplatClipData(*[f[..., ::stride] for f in clip]), config)
    y0 = rects.y0[None, :]
    y1 = (rects.y0 + rects.h)[None, :]
    w = rects.w.to(torch.float32)[None, :]
    rows = torch.arange(config.tiles_y, dtype=torch.int32, device=w.device)[:, None]
    return torch.sum(torch.where((rows >= y0) & (rows < y1), w, 0.0), dim=1)


def _band_bounds(weights: torch.Tensor, n_dev: int, max_rows: int) -> torch.Tensor:
    """Equal-work band boundaries [n_dev + 1] int32, on the weights' device.

    Boundary j lands where the cumulative row weight crosses j/n_dev of
    the total, on the side of the crossing whose cumulative weight is
    closer (ties go up: ``above - target <= target - below``), clamped so
    that every band has 1 to ``max_rows`` rows and the remaining bands can
    still cover the remaining rows.  The JAX package's f32 arithmetic.
    """
    ty = weights.shape[0]
    dev = weights.device
    cdf = torch.cumsum(weights, 0)
    total = cdf[-1]

    def i32(v):
        # A fill on the device: no host-to-device copy inside the frame.
        return torch.full((), v, dtype=torch.int32, device=dev)

    def at(i):
        # cdf[i] for a 0-d tensor i, as a gather: indexing by a 0-d
        # tensor reads it to the host.
        return torch.take(cdf, i.long())

    prev = i32(0)
    bounds = [prev]
    for j in range(1, n_dev):
        target = total * (j / n_dev)
        b0 = torch.sum((cdf < target).to(torch.int32))
        below = torch.where(b0 > 0, at(torch.clamp(b0 - 1, min=0)), 0.0)
        above = at(torch.clamp(b0, max=ty - 1))
        b = torch.where(above - target <= target - below, b0 + 1, b0).to(torch.int32)
        lo = torch.maximum(prev + 1, i32(ty - (n_dev - j) * max_rows))
        hi = torch.minimum(prev + max_rows, i32(ty - (n_dev - j)))
        prev = torch.minimum(torch.maximum(b, lo), hi)
        bounds.append(prev)
    bounds.append(i32(ty))
    return torch.stack(bounds)


def _band_image(clip, colors, opacities, config: RenderConfig, capacity: int,
                band_lo, band_hi, max_rows: int):
    """Render one contiguous band of tile rows [band_lo, band_hi).

    The bounds are ints (uniform bands) or 0-d int32 tensors on the clip
    data's device (balanced bands, chosen on the device).  Candidate rects
    are clamped to the band (ops.binning.splat_tile_rects), so each
    (splat, tile) pair is emitted in exactly one band and num_candidates
    counts only the band's tiles.  The raster buffer holds ``max_rows``
    tile rows from band_lo (a balanced band is at most twice the uniform
    one); its tiles past the band are masked to zero counts.
    Returns (band image [max_rows * tile_size, W, 4] uint8, the pairs).
    """
    band_tiles = max_rows * config.tiles_x
    pairs = build_tile_pairs(clip, colors, opacities, config, capacity,
                             row_band=(band_lo, band_hi))
    keys, _, attrs = sort_pairs(pairs, stable=config.stable_sort)
    starts, counts = tile_ranges(keys, config)
    # The buffer's tiles gathered from band_lo on, the JAX dynamic_slice;
    # padded so that the gather stays in range for any band.
    pad = starts.new_zeros(band_tiles)
    buffer = torch.arange(band_tiles, device=starts.device)
    index = band_lo * config.tiles_x + buffer
    starts_b = torch.cat([starts, pad]).index_select(0, index)
    counts_b = torch.where(buffer < (band_hi - band_lo) * config.tiles_x,
                           torch.cat([counts, pad]).index_select(0, index), 0)
    tiles = rasterize_tiles(
        pack_pair_data(attrs, config.raster_chunk), starts_b, counts_b, config,
        num_tiles=band_tiles, tile_row_offset=band_lo,
    )
    return tiles_to_image(tiles, config), pairs


def _place_band(img: torch.Tensor, band_lo, band_hi, config: RenderConfig):
    """The band's rows at their place in a zeroed full-height frame; the
    buffer's rows past the band are zeroed.  The JAX pad plus
    dynamic_update_slice: rows go to a frame padded by the buffer's height
    at a device index, so the bounds may be 0-d tensors.  Bands partition
    the tile rows, so the element-wise sum of every band's placed frame is
    the image."""
    ts = config.tile_size
    rows = torch.arange(img.shape[0], device=img.device)
    band = torch.where((rows < (band_hi - band_lo) * ts)[:, None, None], img, 0)
    full = img.new_zeros((config.screen_h + img.shape[0],) + tuple(img.shape[1:]))
    full.index_copy_(0, band_lo * ts + rows, band)
    return full[:config.screen_h]


def _balanced_rows(config: RenderConfig, n_dev: int) -> int:
    """The raster buffer's height in tile rows for a balanced band: twice
    the uniform band (the bounds' ``max_rows`` clamp)."""
    return min(config.tiles_y, 2 * (config.tiles_y // n_dev))


def render_band(scene: GaussianScene, camera_data: dict, config: RenderConfig, capacity: int,
                n_dev: int, dev: int, *, device=None):
    """Band ``dev`` of an ``n_dev``-rank balanced frame, on one device with
    no process group: the per-rank program of ``config.balanced_bands``
    without the collectives (the scene arrives whole instead of gathered;
    the band is placed into a zeroed full-height frame instead of summed
    over ranks).  Summing the returned frames over dev = 0..n_dev-1 gives
    the balanced frame exactly.

    Returns (full-height frame [H, W, 4] uint8 on ``device``, aux with the
    band's ``num_candidates``, ``num_pairs`` and its ``band_lo``,
    ``band_hi``: 0-d int32 tensors, as the JAX function returns arrays).

    The host's part: the camera goes to the device here, then
    render_band_tensors runs the band."""
    d = resolve_device(device)
    return render_band_tensors(scene.to(d), camera_tensors(camera_data, d), config, capacity,
                               n_dev, dev)


def render_band_tensors(scene: GaussianScene, cam: Dict[str, torch.Tensor],
                        config: RenderConfig, capacity: int, n_dev: int, dev: int):
    """The device part of render_band, on the device of ``scene``, the
    camera as the tensors of render.camera_tensors or camera_views.  It
    copies nothing from the host and reads nothing back, so a CUDA graph
    can capture it."""
    capacity = round_capacity(capacity, scene.means.device)
    colors = splat_colors(scene, cam)
    clip = project_splats(scene.means, scene.scales, scene.quats, cam, config,
                          opacities=scene.opacities)
    max_rows = _balanced_rows(config, n_dev)
    bounds = _band_bounds(_band_weights(clip, config), n_dev, max_rows)
    band_lo, band_hi = bounds[dev], bounds[dev + 1]
    img, pairs = _band_image(clip, colors, scene.opacities, config, capacity, band_lo, band_hi,
                             max_rows)
    aux = dict(num_candidates=pairs.num_candidates, num_pairs=pairs.num_pairs,
               band_lo=band_lo, band_hi=band_hi)
    return _place_band(img, band_lo, band_hi, config), aux


# ---------------------------------------------------------------------------
# The per-rank frame
# ---------------------------------------------------------------------------


def shard_scene(scene: GaussianScene, mesh: Mesh, axis: str = "tiles") -> GaussianScene:
    """This rank's contiguous 1/n of the splats along ``axis`` of the mesh,
    on the mesh's device (its ``count``: the real splats in the slice)."""
    n = mesh.shape[axis]
    m = scene.padded_count // n
    lo = mesh.index(axis) * m
    sl = slice(lo, lo + m)
    dev = mesh.device

    def take(a):
        return a[..., sl].contiguous().to(dev)

    return dataclasses.replace(
        scene,
        means=take(scene.means), scales=take(scene.scales), quats=take(scene.quats),
        opacities=take(scene.opacities), colors=take(scene.colors),
        sh=None if scene.sh is None else take(scene.sh),
        count=min(max(scene.count - lo, 0), m),
    )


def _render_shard(shard: GaussianScene, cam: Dict[str, torch.Tensor], config: RenderConfig,
                  capacity_per_device: int, mesh: Mesh, axis: str):
    """One rank's part of a frame: stages A-B on its splats, the all-gather
    of the packed clip data, stages C-F on its band, the frame's
    reassembly.  Returns (the whole frame [H, W, 4] uint8, aux with
    ``num_candidates``, the max over the ranks, and ``num_pairs``, the sum:
    0-d int32 tensors).  No host read and no host-to-device copy between
    its first kernel and its last: a CUDA graph can capture it."""
    n_dev, idx = mesh.shape[axis], mesh.index(axis)
    colors = splat_colors(shard, cam)
    clip = project_splats(shard.means, shard.scales, shard.quats, cam, config,
                          opacities=shard.opacities)
    packed = torch.cat([torch.stack(tuple(clip)), colors, shard.opacities[None]])
    packed = _gather_tiled(packed, mesh, axis, 1)
    clip = SplatClipData(*packed[:CLIP_ROWS].unbind(0))
    colors, opacities = packed[CLIP_ROWS:CLIP_ROWS + 3], packed[CLIP_ROWS + 3]

    rows_per_dev = config.tiles_y // n_dev
    balanced = config.balanced_bands and n_dev > 1
    if balanced:
        # Equal-work bands from the gathered (identical) clip data: every
        # rank computes the same bounds, on its device.
        max_rows = _balanced_rows(config, n_dev)
        bounds = _band_bounds(_band_weights(clip, config), n_dev, max_rows)
        band_lo, band_hi = bounds[idx], bounds[idx + 1]
    else:
        max_rows = rows_per_dev
        band_lo, band_hi = idx * rows_per_dev, (idx + 1) * rows_per_dev
    img, pairs = _band_image(clip, colors, opacities, config, capacity_per_device,
                             band_lo, band_hi, max_rows)
    if balanced:
        frame = _place_band(img, band_lo, band_hi, config)
        dist.all_reduce(frame, dist.ReduceOp.SUM, group=mesh.group(axis))
    else:
        frame = _gather_tiled(img, mesh, axis, 0)
    counts = _gather_tiled(torch.stack([pairs.num_candidates, pairs.num_pairs])[None],
                           mesh, axis, 0)
    # The max over ranks is the saturation signal for a per-rank capacity;
    # the bands partition the pairs, so the sum is the single-device count.
    return frame, dict(num_candidates=counts[:, 0].max(), num_pairs=counts[:, 1].sum())


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _validate(config: RenderConfig, mesh: Mesh, axis: str, scene: GaussianScene):
    n_dev = mesh.shape[axis]
    if config.sort_bands > 1:
        raise ValueError(
            "sort_bands is single-device only: the tile-row-sharded pipeline "
            "already divides the sort across devices; run with sort_bands=0"
        )
    if config.tiles_y % n_dev != 0:
        raise ValueError(f"tiles_y ({config.tiles_y}) must be divisible by the device "
                         f"count ({n_dev}) for tile-row sharding")
    rows = config.tiles_y // n_dev
    if config.balanced_bands and n_dev > 1:
        rows = _balanced_rows(config, n_dev)
    band_tiles = rows * config.tiles_x
    if band_tiles % config.cell_tiles(band_tiles) != 0:
        # Only reachable with an explicit tiles_per_cell.
        raise ValueError(f"per-device tile band ({band_tiles} tiles) must be divisible by "
                         f"tiles_per_cell ({config.tiles_per_cell})")
    n = scene.padded_count
    if n % n_dev != 0:
        raise ValueError(f"splat count ({n}) must be divisible by the device count "
                         f"({n_dev}); pad the scene first (GaussianScene.pad_to_multiple)")


def render_frame_sharded(scene: GaussianScene, camera_data: dict, config: RenderConfig,
                         capacity_per_device: int, mesh: Mesh, axis: str = "tiles"):
    """Mesh-parallel frame: splat-sharded stages A-B, the all-gather,
    tile-row-sharded stages C-F over ``axis``.  ``scene`` is the whole
    scene (every rank renders from its own slice of it).

    Returns (the whole frame [H, W, 4] uint8 on the mesh's device, on every
    rank, where the JAX function returns it sharded by rows; aux with
    ``num_candidates``, the largest band's, and ``num_pairs``, the
    frame's)."""
    _validate(config, mesh, axis, scene)
    return _render_shard(shard_scene(scene, mesh, axis), camera_tensors(camera_data, mesh.device),
                         config, round_capacity(capacity_per_device, mesh.device), mesh, axis)


def stack_cameras(cameras: List[Camera]) -> dict:
    """[Camera] -> a camera_data dict of NumPy arrays with a leading frame
    axis."""
    data = [c.camera_data() for c in cameras]
    return {k: np.stack([np.asarray(d[k]) for d in data]) for k in data[0]}


def _batch_size(camera_batch: dict) -> int:
    return int(np.asarray(next(iter(camera_batch.values()))).shape[0])


def _frames(shard, camera_batch, frames, config, capacity, mesh, axis):
    """Frames ``frames`` of a camera batch, in sequence, tile-row sharded
    over ``axis``: ([F, H, W, 4] uint8, aux of [F] int32 tensors).  The
    cameras go to the device once, as one [F, CAMERA_FLOATS] table;
    nothing is read back."""
    rows = [camera_array({k: np.asarray(v)[i] for k, v in camera_batch.items()}) for i in frames]
    images, cands, pairs = [], [], []
    for cam in torch.from_numpy(np.stack(rows)).to(mesh.device):
        image, aux = _render_shard(shard, camera_views(cam), config, capacity, mesh, axis)
        images.append(image)
        cands.append(aux["num_candidates"])
        pairs.append(aux["num_pairs"])
    return torch.stack(images), dict(num_candidates=torch.stack(cands),
                                     num_pairs=torch.stack(pairs))


def _frames_by_group(shard, camera_batch, config, capacity, mesh, frame_axis, tile_axis):
    """Frame group f renders the f-th contiguous share of the batch (see
    render_frames_sharded); an all-gather over ``frame_axis`` collects the
    groups' frames."""
    n_frames = mesh.shape[frame_axis]
    batch = _batch_size(camera_batch)
    if batch % n_frames != 0:
        raise ValueError(f"camera batch ({batch}) must be divisible by the frame-axis "
                         f"size ({n_frames})")
    per = batch // n_frames
    f = mesh.index(frame_axis)
    images, aux = _frames(shard, camera_batch, range(f * per, (f + 1) * per), config,
                          round_capacity(capacity, mesh.device), mesh, tile_axis)
    return (_gather_tiled(images, mesh, frame_axis, 0),
            {k: _gather_tiled(v, mesh, frame_axis, 0) for k, v in aux.items()})


def render_frames_sharded(scene: GaussianScene, camera_batch: dict, config: RenderConfig,
                          capacity_per_device: int, mesh: Mesh, frame_axis: str = "frames",
                          tile_axis: str = "tiles"):
    """Frame-parallel and tile-row-sharded frames over a 2-D mesh.

    ``camera_batch`` (from ``stack_cameras``) holds a multiple of the
    frame axis's size; frame group f renders the f-th contiguous share in
    sequence, tile-row sharded over ``tile_axis``, and an all-gather over
    ``frame_axis`` collects the groups' frames.  Returns (frames [B, H, W,
    4] uint8 and aux of [B] tensors, whole on every rank)."""
    _validate(config, mesh, tile_axis, scene)
    return _frames_by_group(shard_scene(scene, mesh, tile_axis), camera_batch, config,
                            capacity_per_device, mesh, frame_axis, tile_axis)


def render_frames_tilesharded(scene: GaussianScene, camera_batch: dict, config: RenderConfig,
                              capacity_per_device: int, mesh: Mesh, axis: str = "tiles"):
    """Every frame of a camera batch in sequence on a 1-axis (tile-row)
    mesh, every rank in each frame.  Returns (frames [B, H, W, 4] uint8,
    aux of [B] tensors), whole on every rank."""
    _validate(config, mesh, axis, scene)
    return _frames(shard_scene(scene, mesh, axis), camera_batch,
                   range(_batch_size(camera_batch)), config,
                   round_capacity(capacity_per_device, mesh.device), mesh, axis)


class DistributedRenderer:
    """render.Renderer across the ranks of a mesh: per-rank adaptive
    capacity driven by the largest band's candidate count, and the
    reference's saturation handling (an overflowing frame renders
    truncated; the next frame grows).  Every rank calls ``render`` with
    the same camera and gets the whole frame.

    The rank's frame (_render_shard over its shard) reads the camera from
    a static tensor, allocated once and refilled in place.  On the card it
    runs from a cache keyed like the JAX DistributedRenderer's jit cache
    (``_get_fn``'s ``(capacity, batched)``) without ``batched``, since a
    batch replays the one-frame graph once a camera: a key's first frame
    runs eagerly under render.run_sync_free, its second captures the frame,
    collectives included, as a CUDA graph, and later ones replay it
    (render.run_graphed).  The key comes from the largest band's candidate
    count, which every rank reads back, so every rank captures and replays
    the same key on the same frame, as its collectives require.  A failed
    capture raises.  On the CPU (gloo) the same frame runs eagerly over the
    same static tensor.

    A graph holds no reference to the tensors it reads: the renderer keeps
    its shard.  As the JAX DistributedRenderer passes ``self.scene`` to its
    jitted frame on every call, a scene assigned to ``self.scene`` (the
    same on every rank) renders from the next frame on: that frame pads
    and shards it as __init__ does and drops the graphs of the old shard
    (the capacity stays).  A new config takes a new DistributedRenderer."""

    MAX_CAPACITY = _KERNEL_MAX_CAPACITY

    def __init__(self, scene: GaussianScene, config: RenderConfig = RenderConfig(), *,
                 mesh: Optional[Mesh] = None, n_devices: Optional[int] = None):
        self.mesh = mesh if mesh is not None else make_mesh(n_devices)
        self.device = self.mesh.device
        self.axes = self.mesh.axis_names
        self.tile_axis = self.axes[-1]
        self.n_tile_devices = self.mesh.shape[self.tile_axis]
        self.n_frame_devices = self.mesh.shape[self.axes[0]] if len(self.axes) == 2 else 1
        self.config = config
        # Splat counts that do not divide are padded up front.
        self.scene = scene.pad_to_multiple(PREP_BLK * self.n_tile_devices)
        _validate(config, self.mesh, self.tile_axis, self.scene)
        self.shard = shard_scene(self.scene, self.mesh, self.tile_axis)
        # The scene self.shard was cut from (_follow_scene).
        self._shard_of = self.scene
        # Per-rank capacity: the global estimate split across bands, clamped
        # to the emit kernel's exact-f32 limit.
        self.capacity = max(1 << 14, config.tile_capacity(self.scene.count) // self.n_tile_devices)
        self.capacity = min(round_capacity(self.capacity, self.device), self.MAX_CAPACITY)
        self.saturated = False
        self.adaptive = config.capacity is None
        self.frame_count = 0
        # The frame's static camera, outside every graph's memory pool.
        self._camera = torch.zeros(CAMERA_FLOATS, dtype=torch.float32, device=self.device)
        self._camera_views = camera_views(self._camera)
        # key -> (graph, (image, counts)); keys whose eager first frame ran;
        # one memory pool for the graphs (render.Renderer's argument holds:
        # replays run one at a time on one stream, and each replay's
        # outputs are copied out before the next).
        self._graphs: Dict[object, tuple] = {}
        self._visited: set = set()
        self._pool = None
        # How the last frame ran: "eager", "capture" or "replay".
        self.last_method: Optional[str] = None

    def _bucket(self, candidates: int) -> int:
        """Per-rank bucket: 20% headroom, 32Ki grain (the per-rank counts
        are smaller and vary more across bands than Renderer's 8% / 64Ki)."""
        want = max(1 << 14, int(candidates * 1.2))
        grain = 1 << 15
        return min(-(-want // grain) * grain, self.MAX_CAPACITY)

    def _update_capacity(self, candidates: int):
        # ``candidates`` is the largest band's candidate count.
        if candidates > self.MAX_CAPACITY:
            warn_capacity_ceiling(self, candidates)
        if self.adaptive:
            self.capacity = self._bucket(candidates)
            self.saturated = False
        else:
            self.saturated = candidates >= self.capacity

    def _grow_if_saturated(self):
        if self.saturated:
            self.capacity = min(self.capacity * 2, self.MAX_CAPACITY)
            self.saturated = False

    def _follow_scene(self) -> None:
        """Take up a scene assigned to ``self.scene`` since the last frame:
        padded, checked and sharded as in __init__, with every graph of the
        old shard dropped, so that the next frame runs eagerly over it."""
        if self.scene is self._shard_of:
            return
        self._graphs, self._visited, self._pool = {}, set(), None
        self.scene = self.scene.pad_to_multiple(PREP_BLK * self.n_tile_devices)
        _validate(self.config, self.mesh, self.tile_axis, self.scene)
        self.shard = shard_scene(self.scene, self.mesh, self.tile_axis)
        self._shard_of = self.scene

    def _key(self) -> int:
        """The graph cache's key: the per-rank capacity."""
        return round_capacity(self.capacity, self.device)

    def _frame(self, key):
        """The rank's frame at ``key`` over the static camera: (the whole u8
        frame, int32 counts [num_candidates (max over ranks), num_pairs])."""
        image, aux = _render_shard(self.shard, self._camera_views, self.config, key, self.mesh,
                                   self.tile_axis)
        return image, torch.stack([aux["num_candidates"], aux["num_pairs"]])

    def _run(self, key):
        return run_graphed(self, key, functools.partial(self._frame, key),
                           error_mode=SHARDED_CAPTURE_MODE)

    def render(self, camera: Camera, *, check_saturation: bool = True) -> np.ndarray:
        """The whole [H, W, 4] uint8 frame as a NumPy array, on every rank."""
        self._grow_if_saturated()
        self._follow_scene()
        self._camera.copy_(torch.from_numpy(camera_array(camera.camera_data())))
        image, counts = self._run(self._key())
        self.frame_count += 1
        if check_saturation:
            self._update_capacity(int(counts[0]))
        return image.cpu().numpy()

    def render_batch(self, cameras: List[Camera], *, check_saturation: bool = True) -> np.ndarray:
        """[B, H, W, 4] uint8 frames: frame-parallel on a 2-D mesh
        (make_mesh_2d; frame group f renders the f-th contiguous share of
        the batch, and one all-gather over the frame axis collects them
        after the frames), in sequence on a 1-axis mesh.  The cameras go to
        the device once (frames_on_device); one readback of the frames and
        one of the counts."""
        self._grow_if_saturated()
        mine = range(len(cameras))
        if len(self.axes) == 2:
            if len(cameras) % self.n_frame_devices != 0:
                raise ValueError(f"camera batch ({len(cameras)}) must be divisible by the "
                                 f"frame-axis size ({self.n_frame_devices})")
            per = len(cameras) // self.n_frame_devices
            f = self.mesh.index(self.axes[0])
            mine = range(f * per, (f + 1) * per)
        table = torch.from_numpy(
            np.stack([camera_array(cameras[i].camera_data()) for i in mine])).to(self.device)
        images, counts = self.frames_on_device(table)
        if len(self.axes) == 2:
            images = _gather_tiled(images, self.mesh, self.axes[0], 0)
            counts = _gather_tiled(counts, self.mesh, self.axes[0], 0)
        self.frame_count += len(cameras)
        if check_saturation:
            self._update_capacity(int(counts[:, 0].max()))
        return images.cpu().numpy()

    def frames_on_device(self, table: torch.Tensor):
        """The device part of render_batch: for each camera of ``table``
        ([F, CAMERA_FLOATS] float32 rows of render.camera_array, on the
        rank's device) a device-to-device refill of the static camera and
        the rank's frame at the current key, copied into one output.
        Returns ([F, H, W, 4] uint8 frames, [F, 2] int32 counts:
        num_candidates, num_pairs), on the device; nothing waits for the
        card.  The capacity does not change within the call."""
        self._follow_scene()
        cfg = self.config
        images = torch.empty((table.shape[0], cfg.screen_h, cfg.screen_w, 4), dtype=torch.uint8,
                             device=self.device)
        counts = torch.empty((table.shape[0], 2), dtype=torch.int32, device=self.device)
        key = self._key()
        for j, cam in enumerate(table):
            self._camera.copy_(cam)
            image, c = self._run(key)
            images[j].copy_(image)
            counts[j].copy_(c)
        return images, counts
