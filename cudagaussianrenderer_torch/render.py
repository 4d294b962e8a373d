"""Frame pipeline orchestration.

One frame runs six stages on one device, with no host synchronization
inside the frame:

  A  ops.sh.evaluate_sh_colors          (torch)
  B  ops.projection.project_splats      (torch)
  C  ops.binning.build_tile_pairs       (torch, then kernels K2 + K3)
  D  ops.sorting.sort_pairs             (kernel sort.cu; torch.sort off the card)
  E  ops.ranges.tile_ranges             (kernel K1)
  F  ops.raster.rasterize_tiles         (kernel K4), then tiles_to_image

On the card a flat frame runs stages A-C's per-splat work as one kernel
(ops.splat.splat_columns: the colour, the projection, the tile rect and
runs, the packed columns), then C's prefix sum and K2 + K3
(ops.binning.build_tile_pairs_from_columns); on the CPU the same call
runs the stage functions above.

With ``config.sort_bands = G > 1`` stages C-E run band-segmented instead:
ops.banded.build_tile_pairs_banded (torch, then kernels K5-K8) emits the
pair list band-major over G tile-row bands, ops.banded.sort_pairs_banded
sorts each band's segment on its own, and tile_ranges takes band-offset
starts (kernel K1 in its segmented mode).

The only optional readback is the candidate-pair count (with the per-band
counts of a banded frame) used for capacity management, which mirrors the
reference's saturation doubling (Demo.cpp:356-366, cu:700-703): when a frame's candidate count exceeds the
list capacity, that frame renders with a truncated list and the next one
gets more capacity.

Entry points run on the card unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper runs its plain PyTorch version.

``Renderer`` keeps the JAX Renderer's compiled frame: on the card it
replays one CUDA graph of the whole frame (render_frame_tensors) per
capacity key, the counterpart of the JAX ``_get_fn`` jit cache, so the
host issues one replay a frame instead of hundreds of launches.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import telemetry
from .config import RenderConfig
from .models.camera import Camera
from .models.scene import GaussianScene
from .ops.banded import build_tile_pairs_banded, sort_pairs_banded
from .ops.binning import build_tile_pairs_from_columns
from .ops.expand import MAX_BLOCK as _EMIT_BLOCK
from .ops.expand import MAX_CAPACITY as _MAX_CAPACITY
from .ops.expand import PREP_BLK as _PREP_BLK
from .ops.projection import project_splats
from .ops.ranges import tile_ranges
from .ops.raster import pack_pair_data, rasterize_tiles, tiles_to_image
from .ops.sorting import sort_pairs, sort_words
from .ops.splat import splat_colors, splat_columns
from .utils.device import resolve_device

# Emit blocks per capacity grain on the card (whole 4096-slot groups, the
# JAX package's grid-step grain, so both packages size lists alike).
_CUDA_GRAIN_BLOCKS = 4

_CAMERA_FIELDS = (
    ("view", (4, 4)),
    ("position", (3,)),
    ("fov_cotangent", (2,)),
    ("depth_scale_bias", (2,)),
    ("aspect", ()),
)


# Floats of one camera in camera_array's layout.
CAMERA_FLOATS = sum(int(np.prod(shape)) for _, shape in _CAMERA_FIELDS)


def camera_array(camera_data: dict) -> np.ndarray:
    """Camera.camera_data() -> its [CAMERA_FLOATS] float32 fields, flat."""
    return np.concatenate(
        [np.asarray(camera_data[k], np.float32).reshape(-1) for k, _ in _CAMERA_FIELDS]
    )


def camera_views(flat: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The camera dict the stages take, as views into one [CAMERA_FLOATS]
    float32 tensor: refilling ``flat`` in place moves the camera."""
    out, off = {}, 0
    for k, shape in _CAMERA_FIELDS:
        n = int(np.prod(shape))
        out[k] = flat[off : off + n].reshape(shape)
        off += n
    return out


def camera_flat(cam: Dict[str, torch.Tensor]) -> torch.Tensor:
    """camera_views' inverse: a camera dict of tensors as one
    [CAMERA_FLOATS] float32 tensor on its device."""
    return torch.cat([cam[k].reshape(-1).to(torch.float32) for k, _ in _CAMERA_FIELDS])


def camera_tensors(camera_data: dict, device) -> Dict[str, torch.Tensor]:
    """Camera.camera_data() (NumPy) -> float32 tensors on ``device``, in
    one host-to-device copy."""
    return camera_views(torch.from_numpy(camera_array(camera_data)).to(device))


def round_capacity(capacity: int, device=None, bands: int = 1) -> int:
    """Round a pair-list capacity up to the emit grain: 4096 slots on the
    card, 128 on the CPU (the JAX package's grain in interpret mode, so
    the CPU tests get the same slot arrays as the JAX tests), times the
    band count for band-segmented lists."""
    dev = torch.device("cuda" if device is None else device)
    grain = (_EMIT_BLOCK * _CUDA_GRAIN_BLOCKS if dev.type == "cuda" else 128) * max(
        1, int(bands)
    )
    return -(-max(1, int(capacity)) // grain) * grain


def warn_capacity_ceiling(renderer, candidates: int) -> None:
    """Warn once per renderer that a frame's candidate count exceeds the
    pair-list ceiling MAX_CAPACITY, so it renders truncated."""
    if getattr(renderer, "_ceiling_warned", False):
        return
    renderer._ceiling_warned = True
    warnings.warn(
        f"frame produced {candidates} candidate pairs, above the pair-list "
        f"capacity ceiling ({renderer.MAX_CAPACITY}); frames past the ceiling "
        "render with a truncated (depth-ordered per tile, but arbitrarily "
        "cut) pair list. Escape hatches: lower the candidate count (smaller "
        "viewport, opacity-aware extents), or render in tile-row passes via "
        "render.render_frame_multipass (n_passes x capacity_per_pass "
        "effective capacity).",
        RuntimeWarning,
        stacklevel=3,
    )


def uniform_band_rows(config: RenderConfig) -> np.ndarray:
    """Default equal-ROW band boundaries for config.sort_bands bands."""
    g = config.sort_bands
    return np.round(np.linspace(0, config.tiles_y, g + 1)).astype(np.int32)


def reorder_scene_by_tile_row(
    scene: GaussianScene, camera_data: dict, config: RenderConfig
) -> GaussianScene:
    """Re-order splats by their projected centre tile row.

    A locality experiment of the JAX package, kept with the banded path:
    the banded frame itself needs no splat order (it compacts each band's
    splats inside the frame), but a scene in this order puts every band's
    splats next to each other, live splats at the array's end included.
    """
    cam = camera_tensors(camera_data, scene.means.device)
    clip = project_splats(
        scene.means, scene.scales, scene.quats, cam, config, opacities=scene.opacities
    )
    row = torch.clamp(
        torch.floor((clip.cy + 1.0) * (0.5 * config.tiles_y)), 0.0, float(config.tiles_y - 1)
    )
    order = torch.argsort(row)
    return dataclasses.replace(
        scene,
        means=scene.means[:, order],
        scales=scene.scales[:, order],
        quats=scene.quats[order],
        opacities=scene.opacities[order],
        colors=scene.colors[:, order],
        sh=None if scene.sh is None else scene.sh[..., order],
    )


def rebalance_band_rows(
    band_rows: torch.Tensor, totals: torch.Tensor, tiles_y: int
) -> torch.Tensor:
    """Equal-count boundary update on the device (Renderer._rebalance_bands'
    tensor twin, for a frame loop that never leaves the device): move
    boundary k to the row where the piecewise-linear cumulative load
    crosses k/G of the total, assuming uniform density within each current
    band.  f32 arithmetic, as in the JAX package."""
    g = band_rows.shape[0] - 1
    dev = band_rows.device
    rows = band_rows.to(torch.float32)
    cum = torch.cat(
        [torch.zeros(1, dtype=torch.float32, device=dev),
         torch.cumsum(totals.to(torch.float32), 0)]
    )
    total = cum[-1]
    targets = torch.arange(1, g, dtype=torch.float32, device=dev) * (total / g)
    # Band containing each target (compare-sum; G is tiny).
    k = (cum[1:-1][None, :] <= targets[:, None] - 0.5).sum(1)
    lo_c = cum[k]
    span_c = torch.clamp(cum[k + 1] - lo_c, min=1e-9)
    frac = (targets - lo_c) / span_c
    lo_r = rows[k]
    new = lo_r + frac * (rows[k + 1] - lo_r)
    arr = torch.cat(
        [torch.zeros(1, dtype=torch.float32, device=dev), torch.round(new),
         torch.full((1,), float(tiles_y), dtype=torch.float32, device=dev)]
    ).to(torch.int32)
    arr = torch.clamp(torch.cummax(arr, 0).values, 0, tiles_y)
    # An empty frame (total 0) would collapse every boundary to 0; fall
    # back to equal rows so the next live frame starts balanced-ish.
    uniform = torch.round(
        torch.arange(g + 1, dtype=torch.float32, device=dev) * (tiles_y / g)
    ).to(torch.int32)
    return torch.where(total > 0, arr, uniform)


def _band_rows_tensor(band_rows, config: RenderConfig, device) -> torch.Tensor:
    """[sort_bands + 1] int32 tile-row boundaries on ``device`` (None =
    equal rows), checked against the band count."""
    if band_rows is None:
        band_rows = uniform_band_rows(config)
    band_rows = torch.as_tensor(band_rows).to(device=device, dtype=torch.int32)
    # The emit, sort and ranges stages each derive the band count
    # independently; a mismatched band_rows would silently disagree on
    # segment boundaries and corrupt the frame.
    if band_rows.shape != (config.sort_bands + 1,):
        raise ValueError(
            f"band_rows must have sort_bands + 1 = {config.sort_bands + 1} "
            f"entries, got {tuple(band_rows.shape)}"
        )
    return band_rows


def _no_stamp(boundary: int) -> None:
    pass


def _frame_pairs(scene, cam, config, capacity, row_band=None, stamp=_no_stamp):
    """Stages A-E of a flat frame: (pairs, sorted attribute words, starts,
    counts).  ``stamp(i)`` marks boundary i of the stages (0 before A, 5
    after E; telemetry.STAGES).  Stages A-C's per-splat work is one kernel
    (ops.splat.splat_columns) between stamps 0 and 1, so nothing runs
    between stamps 1 and 2, and stage C's prefix sum and kernels K2 and K3
    run between stamps 2 and 3."""
    stamp(0)
    cols, counts = splat_columns(scene, cam, config, row_band=row_band)
    stamp(1)
    stamp(2)
    pairs = build_tile_pairs_from_columns(cols, counts, capacity, config)
    stamp(3)
    sorted_keys, _, sorted_attrs = sort_pairs(pairs, stable=config.stable_sort)
    stamp(4)
    starts, counts = tile_ranges(sorted_keys, config)
    stamp(5)
    return pairs, sorted_attrs, starts, counts


def _frame_pairs_banded(scene, cam, config, capacity, band_rows, compact_capacity,
                        stamp=_no_stamp):
    """Stages A-E of a banded frame: (pairs, sorted attribute words,
    starts, counts, band_totals, band_splats), with _frame_pairs' stamps."""
    stamp(0)
    colors = splat_colors(scene, cam)
    stamp(1)
    clip = project_splats(
        scene.means, scene.scales, scene.quats, cam, config, opacities=scene.opacities
    )
    stamp(2)
    pairs, band_totals, band_splats = build_tile_pairs_banded(
        clip, colors, scene.opacities, config, capacity, band_rows,
        compact_capacity=compact_capacity,
    )
    stamp(3)
    sorted_keys, _, sorted_attrs = sort_pairs_banded(
        pairs, config.sort_bands, stable=config.stable_sort
    )
    stamp(4)
    starts, counts = tile_ranges(
        sorted_keys, config, band_rows=band_rows,
        band_capacity=capacity // config.sort_bands,
    )
    stamp(5)
    return pairs, sorted_attrs, starts, counts, band_totals, band_splats


def render_frame(
    scene: GaussianScene,
    camera_data: dict,
    config: RenderConfig,
    capacity: int,
    *,
    band_rows=None,
    compact_capacity: int = 0,
    device=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Render one frame on ``device`` (default: the card).

    Returns (image uint8 [H, W, 4] tensor on the device, aux dict with the
    scalar tensors ``num_candidates`` and ``num_pairs``).

    With config.sort_bands = G > 1 the pair list is emitted band-major over
    G tile-row bands and sorted one band's segment at a time.
    ``band_rows`` ([G + 1] tile-row boundaries) tunes the band balance —
    Renderer feeds back the previous frame's per-band counts; None = equal
    rows.  ``compact_capacity`` sizes the compacted splat axis (0 = 2x the
    splat count).  The aux dict then also holds ``band_totals`` and
    ``band_splats`` ([G] unclamped per-band pair and splat counts).

    The host's part: the camera and the band rows go to the device here,
    then render_frame_tensors runs the frame.
    """
    dev = resolve_device(device)
    if config.sort_bands > 1:
        band_rows = _band_rows_tensor(band_rows, config, dev)
    return render_frame_tensors(
        scene.to(dev), camera_tensors(camera_data, dev), config, capacity,
        band_rows=band_rows, compact_capacity=compact_capacity,
    )


def render_frame_tensors(
    scene: GaussianScene,
    cam: Dict[str, torch.Tensor],
    config: RenderConfig,
    capacity: int,
    *,
    band_rows: Optional[torch.Tensor] = None,
    compact_capacity: int = 0,
    stamp=_no_stamp,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The device part of render_frame, on the device of ``scene``: the
    camera as the tensors of camera_tensors or camera_views, and, for a
    banded frame, ``band_rows`` as a [G + 1] int32 tensor on that device.
    The aux dict also holds ``pairs_blended``, K4's count of the pairs the
    tiles blended before their exits (a [1] int32 tensor).

    It copies nothing from the host and waits for nothing on the device,
    so a CUDA graph can capture it (the bench replays one per camera).
    ``stamp(i)`` marks the 8 boundaries of telemetry.STAGES (Renderer
    passes its stamp ring's, which a graph captures with the frame).
    """
    banded = config.sort_bands > 1
    capacity = round_capacity(
        capacity, scene.means.device, bands=config.sort_bands if banded else 1
    )
    aux = {}
    if banded:
        if band_rows is None:
            raise ValueError("a banded frame needs band_rows as a device tensor")
        pairs, sorted_attrs, starts, counts, aux["band_totals"], aux["band_splats"] = (
            _frame_pairs_banded(scene, cam, config, capacity, band_rows, compact_capacity,
                                stamp)
        )
    else:
        pairs, sorted_attrs, starts, counts = _frame_pairs(scene, cam, config, capacity,
                                                           stamp=stamp)
    pair_data = pack_pair_data(sorted_attrs, config.raster_chunk)
    blended = torch.zeros(1, dtype=torch.int32, device=scene.means.device)
    tiles = rasterize_tiles(pair_data, starts, counts, config, blended=blended)
    stamp(6)
    image = tiles_to_image(tiles, config)
    stamp(7)
    return image, dict(num_candidates=pairs.num_candidates, num_pairs=pairs.num_pairs,
                       pairs_blended=blended, **aux)


def run_sync_free(frame):
    """``frame()`` run eagerly under ``torch.cuda.set_sync_debug_mode("error")``:
    a host sync or a host-to-device copy inside it raises, where a capture
    would bake a stale value or a dead host pointer into the graph."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return frame()
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def capture_frame(frame, device, *, pool=None, checked: bool = False,
                  error_mode: str = "global", warmup=None, record=None):
    """Capture ``frame()`` as a CUDA graph on ``device``, by PyTorch's
    recipe: (1) one eager frame under run_sync_free, unless ``checked``
    says the caller has run one; (2) a warm-up on a side stream, so that
    every lazy initialisation (the kernels' libraries, their cached device
    attributes, the sort's workspace) happens before the capture; (3) the
    capture, into the memory pool ``pool`` (None: a pool of its own), with
    ``torch.cuda.graph``'s ``capture_error_mode`` ``error_mode``: "global"
    refuses a CUDA call that is unsafe during a capture from any thread of
    the process, "thread_local" only from this one.

    The warm-up calls ``warmup()`` where one is given: for a frame with
    side effects (a training step that writes its new state in place, or
    runs a collective every rank must match), the same work without them.

    The device is synchronised just before ``torch.cuda.graph`` is
    entered, as its ``__enter__`` does first, so that a ``record``
    (telemetry.FrameRecorder) books the wait for the warm-up apart from
    the allocator's flush: it gets the spans capture.warmup, capture.sync,
    capture.flush (``__enter__``), capture.record (the frame under
    capture) and capture.instantiate (``capture_end``), end to end.

    Returns (the graph, the captured call's outputs).  The outputs are
    static: each replay writes them anew.  A failed capture raises."""
    rec = telemetry.NO_RECORD if record is None else record
    if not checked:
        run_sync_free(frame)
    rec.begin(telemetry.CAPTURE_WARMUP)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        (frame if warmup is None else warmup)()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    rec.switch(telemetry.CAPTURE_WARMUP, telemetry.CAPTURE_SYNC)
    torch.cuda.synchronize(device)
    rec.switch(telemetry.CAPTURE_SYNC, telemetry.CAPTURE_FLUSH)
    with torch.cuda.graph(graph, pool=pool, capture_error_mode=error_mode):
        rec.switch(telemetry.CAPTURE_FLUSH, telemetry.CAPTURE_RECORD)
        outputs = frame()
        rec.switch(telemetry.CAPTURE_RECORD, telemetry.CAPTURE_INSTANTIATE)
    rec.end(telemetry.CAPTURE_INSTANTIATE)
    return graph, outputs


def run_graphed(owner, key, frame, error_mode: str = "global", warmup=None, record=None):
    """``frame()``, the frame at ``key`` of a renderer ``owner`` that keeps a
    graph cache (``device``, ``_graphs``: key -> (graph, outputs),
    ``_visited``, ``_pool``, ``last_method``): eager on the CPU; on the
    card eager under run_sync_free on the key's first visit, captured by
    capture_frame (with ``error_mode`` and ``warmup``) into the owner's one
    pool and replayed on its second, replayed after that.  Returns the
    frame's outputs, static ones when replayed.  A ``record``
    (telemetry.FrameRecorder) gets the span of the way the frame ran:
    eager, capture (with capture_frame's spans) or replay, and a
    capture's first replay as a replay."""
    rec = telemetry.NO_RECORD if record is None else record
    if owner.device.type != "cuda":
        owner.last_method = "eager"
        rec.begin(telemetry.EAGER)
        outputs = frame()
        rec.end(telemetry.EAGER)
        return outputs
    if key in owner._graphs:
        graph, outputs = owner._graphs[key]
        owner.last_method = "replay"
    elif key not in owner._visited:
        owner._visited.add(key)
        owner.last_method = "eager"
        rec.begin(telemetry.EAGER)
        outputs = run_sync_free(frame)
        rec.end(telemetry.EAGER)
        return outputs
    else:
        if owner._pool is None:
            owner._pool = torch.cuda.graph_pool_handle()
        kw = {} if warmup is None else {"warmup": warmup}
        if record is not None:
            kw["record"] = record
        rec.begin(telemetry.CAPTURE)
        graph, outputs = capture_frame(frame, owner.device, pool=owner._pool, checked=True,
                                       error_mode=error_mode, **kw)
        rec.end(telemetry.CAPTURE)
        owner._graphs[key] = (graph, outputs)
        owner.last_method = "capture"
    rec.begin(telemetry.REPLAY)
    graph.replay()
    rec.end(telemetry.REPLAY)
    return outputs


def render_frame_multipass(
    scene: GaussianScene,
    camera_data: dict,
    config: RenderConfig,
    capacity_per_pass: int,
    n_passes: int,
    *,
    device=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Render in ``n_passes`` tile-row bands, each an independent build ->
    sort -> ranges -> raster over only that band's pairs, so the effective
    frame capacity is n_passes * capacity_per_pass.  tiles_y must divide
    by n_passes."""
    if config.tiles_y % n_passes != 0:
        raise ValueError(
            f"n_passes ({n_passes}) must divide tiles_y ({config.tiles_y})"
        )
    if config.sort_bands > 1:
        raise ValueError("use sort_bands OR multipass, not both")
    band_tiles = (config.tiles_y // n_passes) * config.tiles_x
    if band_tiles % config.cell_tiles(band_tiles) != 0:
        raise ValueError(
            f"per-pass tile count ({band_tiles}) must be a multiple of "
            f"tiles_per_cell ({config.tiles_per_cell}) — use fewer passes "
            f"or a smaller tiles_per_cell"
        )
    dev = resolve_device(device)
    capacity_per_pass = round_capacity(capacity_per_pass, dev)
    scene = scene.to(dev)
    cam = camera_tensors(camera_data, dev)
    rows_per = config.tiles_y // n_passes
    images, pass_candidates, pass_pairs = [], [], []
    for p in range(n_passes):
        lo = p * rows_per
        pairs, sorted_attrs, starts, counts = _frame_pairs(
            scene, cam, config, capacity_per_pass, row_band=(lo, lo + rows_per)
        )
        sl = slice(lo * config.tiles_x, lo * config.tiles_x + band_tiles)
        tiles = rasterize_tiles(
            pack_pair_data(sorted_attrs, config.raster_chunk),
            starts[sl].contiguous(), counts[sl].contiguous(), config,
            num_tiles=band_tiles, tile_row_offset=lo,
        )
        images.append(tiles_to_image(tiles, config))
        pass_candidates.append(pairs.num_candidates)
        pass_pairs.append(pairs.num_pairs)
    pass_candidates = torch.stack(pass_candidates)
    pass_pairs = torch.stack(pass_pairs)
    return torch.cat(images, dim=0), dict(
        num_candidates=pass_candidates.sum(),
        num_pairs=pass_pairs.sum(),
        pass_candidates=pass_candidates,
        pass_pairs=pass_pairs,
    )


# Stage names exactly as the reference prints them at exit
# (Demo.cpp:556-562), for comparable profiling reports: the frame record's
# stages but the last (telemetry.STAGES; tilesToImage is the port's own).
STAGE_NAMES = telemetry.STAGES[:6]
# Where a frame's counts hold telemetry.COUNTERS: the candidates first, K4's
# pairs blended and the pairs listed last (Renderer._frame).
_COUNTERS_AT = [0, -1, -2]


class Renderer:
    """Stateful host-side renderer: graph caching, capacity management,
    the banded path's boundary controller, and a record of every frame
    (telemetry), on one device (default: the card).

    The frame (render_frame_tensors over this renderer's scene) reads the
    camera and the band rows from static tensors, allocated once and
    refilled in place before each frame.  On the card it runs from a cache
    keyed like the JAX Renderer's jit cache (``_get_fn``): ``capacity``
    for a flat renderer, ``(capacity, compact_capacity)`` for a banded one;
    the band rows are an input, so rebalancing captures nothing new.  A
    key's first frame runs eagerly under run_sync_free, its second captures
    the frame as a CUDA graph (capture_frame) and replays it, and every
    later one replays it.  A failed capture or replay raises.  On the CPU
    the same frame runs eagerly over the same static tensors.

    A graph reads the tensors of the scene it was captured over.  The JAX
    Renderer passes ``self.scene`` to its jitted frame on every call, so a
    scene assigned to ``renderer.scene`` renders from the next frame on;
    here that frame finds the new scene, moves and pads it as __init__
    does, and drops the graphs, the visited keys and their memory pool
    (the capacity stays, as in the JAX Renderer).  A new config takes a
    new Renderer.

    Every render call leaves a frame record (telemetry.FrameRecorder):
    its host spans, its method and key, its counters (candidates, pairs
    listed, pairs blended, read back with the counts) and the device
    stamps of its stages, which a captured graph writes on each replay."""

    # Hard capacity ceiling: prefix sums travel as exact f32 integers.
    MAX_CAPACITY = _MAX_CAPACITY

    def __init__(self, scene: GaussianScene, config: RenderConfig = RenderConfig(), *,
                 device=None):
        self.config = config
        self.device = resolve_device(device)
        self.scene = scene.to(self.device).pad_to_multiple(_PREP_BLK)
        # The scene the graphs were captured over (_follow_scene).
        self._graph_scene = self.scene
        self.capacity = min(
            round_capacity(config.tile_capacity(self.scene.count), self.device),
            self.MAX_CAPACITY,
        )
        self.saturated = False
        # Whether the last frame (with check_saturation) overflowed a list
        # and so rendered truncated; its lists are grown for the next one.
        self.last_truncated = False
        self.stats = {name: 0.0 for name in STAGE_NAMES}
        self.frame_count = 0
        self.profiled_count = 0
        # Adaptive capacity: buckets sized from the previous frame's
        # candidate count (every post-binning stage costs O(capacity)).
        # An explicit config.capacity opts into the reference's fixed
        # grow-only behavior instead.
        self.adaptive_capacity = config.capacity is None
        self._ceiling_warned = False
        self.last_candidates = 0
        # Band-segmented state (config.sort_bands > 1): the equal-count
        # boundary controller and the adaptive compacted-splat capacity.
        # The frame compacts each band's splats itself, so no splat order
        # and no other state crosses frames.
        self.banded = config.sort_bands > 1
        self.n_bands = max(1, config.sort_bands)
        self.band_rows = uniform_band_rows(config) if self.banded else None
        self.last_band_totals: Optional[np.ndarray] = None
        self.last_band_splats: Optional[np.ndarray] = None
        if self.banded:
            self.capacity = self._round_banded(self.capacity)
            self.compact_capacity = self._round_banded(2 * self.scene.padded_count)
        # The frame's static inputs, outside every graph's memory pool: the
        # camera and, after it, the frame's row of the stamp ring.
        self._inputs = torch.zeros(CAMERA_FLOATS + 1, dtype=torch.float32, device=self.device)
        # Their host row, written in place each frame (pinned on the card).
        self._inputs_host = torch.zeros(CAMERA_FLOATS + 1, dtype=torch.float32,
                                        pin_memory=self.device.type == "cuda")
        self._inputs_row = self._inputs_host.numpy()
        self._camera = self._inputs[:CAMERA_FLOATS]
        self._camera_views = camera_views(self._camera)
        self._band_rows = (torch.zeros(self.n_bands + 1, dtype=torch.int32, device=self.device)
                           if self.banded else None)
        # key -> (graph, (image, counts)); keys whose eager first frame ran.
        # All graphs share one memory pool.  That is safe because replays
        # run one at a time on one stream, each replay's outputs are copied
        # to the host before the next replay, and the static inputs live
        # outside the pool: a graph may overwrite another's temporaries and
        # outputs, but never while they are still to be read.
        self._graphs: Dict[object, tuple] = {}
        self._visited: set = set()
        self._pool = None
        # How the last frame ran: "eager", "capture" or "replay".
        self.last_method: Optional[str] = None
        # key -> the stage-D path (ops.sorting.SORT_PATHS) its last eager or
        # captured frame ran: the one the key's graph holds.
        self._sort_paths: Dict[object, str] = {}
        # The frame records, and the stamp ring the frame writes.
        self._record = telemetry.FrameRecorder(self.device, self._inputs[CAMERA_FLOATS:])

    @classmethod
    def _bucket(cls, candidates: int) -> int:
        """Capacity bucket: 8% headroom, 64Ki granularity."""
        want = max(1 << 17, int(candidates * 1.08))
        grain = 1 << 16
        return min(-(-want // grain) * grain, cls.MAX_CAPACITY)

    def _round_banded(self, capacity: int) -> int:
        """Clamp + round a capacity to the banded grain (bands x blocks,
        via round_capacity — one source of the grain rule), never
        exceeding MAX_CAPACITY."""
        grain = round_capacity(1, self.device, self.n_bands)
        cap = round_capacity(min(capacity, self.MAX_CAPACITY), self.device, self.n_bands)
        return min(cap, self.MAX_CAPACITY // grain * grain)

    def _bucket_banded(self, band_max: int) -> int:
        """Adaptive banded capacity from the max per-band count: more
        headroom than the flat bucket (20%) because the equal-count
        controller lags the view by a frame, at a finer 16Ki per-band
        grain."""
        per_band = max(1 << 14, int(band_max * 1.20))
        per_band = -(-per_band // (1 << 14)) * (1 << 14)
        return self._round_banded(per_band * self.n_bands)

    def _rebalance_bands(self, totals: np.ndarray) -> None:
        """Move band boundaries toward equal per-band pair counts.

        Models the row density as uniform within each current band; new
        boundary k sits at the row where the piecewise-linear cumulative
        load crosses k/G of the total.  Converges in a few frames for a
        smooth camera; per-band capacity headroom covers the transient.
        """
        total = int(totals.sum())
        ty = self.config.tiles_y
        g = self.n_bands
        if total <= 0:
            self.band_rows = uniform_band_rows(self.config)
            return
        rows = self.band_rows.astype(np.float64)
        cum = np.concatenate([[0.0], np.cumsum(totals.astype(np.float64))])
        targets = np.arange(1, g) * (total / g)
        k = np.searchsorted(cum[1:-1], targets, side="left")  # band of target
        span_c = np.maximum(cum[k + 1] - cum[k], 1e-9)
        frac = (targets - cum[k]) / span_c
        new_rows = rows[k] + frac * (rows[k + 1] - rows[k])
        arr = np.concatenate([[0], np.round(new_rows), [ty]]).astype(np.int32)
        self.band_rows = np.maximum.accumulate(np.clip(arr, 0, ty))

    def render(self, camera: Camera, *, check_saturation: bool = True) -> np.ndarray:
        """Render and return a [H, W, 4] uint8 numpy image.

        The camera and band rows go into the static inputs, then the frame
        runs at the current key (eager, captured or replayed; see the
        class).  ``check_saturation`` reads the frame's counts back to the
        host in one copy and resizes the lists for the NEXT frame; the
        current frame renders with a truncated list if it overflowed.
        Without it only the image is read back.
        """
        rec = self._record
        rec.begin_frame()
        if self.saturated:
            # Demo.cpp:356-366 grow-on-saturation behavior.
            cap = min(self.capacity * 2, self.MAX_CAPACITY)
            self.capacity = self._round_banded(cap) if self.banded else cap
            self.saturated = False
        self._follow_scene()
        rec.begin(telemetry.INPUTS)
        self._inputs_row[:CAMERA_FLOATS] = camera_array(camera.camera_data())
        self._inputs_row[CAMERA_FLOATS] = rec.row
        self._inputs.copy_(self._inputs_host)
        if self.banded:
            self._band_rows.copy_(_band_rows_tensor(self.band_rows, self.config, "cpu"))
        rec.end(telemetry.INPUTS)
        key = self._key()
        image, counts = self._run(key)
        self.frame_count += 1
        rec.begin(telemetry.READBACK)
        counters = None
        if check_saturation:
            counts = counts.cpu().numpy()
            # The counts end with K4's blended pairs and the pairs listed.
            counters = counts[_COUNTERS_AT]
            if self.banded:
                self._update_banded(counts)
            else:
                self._update_flat(int(counts[0]))
        image = image.cpu().numpy()
        rec.end(telemetry.READBACK)
        rec.end_frame(self.last_method, key, counters, self._sort_paths.get(key))
        return image

    def _follow_scene(self) -> None:
        """Take up a scene assigned to ``self.scene`` since the last frame:
        on the device and padded as in __init__, with every graph of the
        old scene dropped, so that the next frame runs eagerly over it."""
        if self.scene is self._graph_scene:
            return
        self.scene = self.scene.to(self.device).pad_to_multiple(_PREP_BLK)
        self._graph_scene = self.scene
        self._graphs, self._visited, self._pool = {}, set(), None

    def _key(self):
        """The graph cache's key: the JAX Renderer's jit cache key."""
        return (self.capacity, self.compact_capacity) if self.banded else self.capacity

    def _frame(self, key):
        """The frame at ``key`` over the static inputs, stamped into this
        renderer's ring: (u8 image, int32 counts: num_candidates, for a
        banded frame band_totals and band_splats after it, then K4's
        pairs blended and the pairs listed)."""
        capacity, compact_capacity = key if self.banded else (key, 0)
        sorts = sort_words.launches
        image, aux = render_frame_tensors(
            self.scene, self._camera_views, self.config, capacity,
            band_rows=self._band_rows, compact_capacity=compact_capacity,
            stamp=self._record.stamp,
        )
        self._sort_paths[key] = "kernel" if sort_words.launches > sorts else "torch"
        counts = [aux["num_candidates"].reshape(1)]
        if self.banded:
            counts += [aux["band_totals"], aux["band_splats"]]
        counts += [aux["pairs_blended"], aux["num_pairs"].reshape(1)]
        return image, torch.cat([c.to(torch.int32) for c in counts])

    def _run(self, key):
        """The frame at ``key``: eager on the CPU; on the card eager on the
        key's first visit, captured on its second, replayed after that."""
        return run_graphed(self, key, functools.partial(self._frame, key),
                           record=self._record)

    def _update_flat(self, candidates: int) -> None:
        """The capacity for the next frame, from this frame's candidates."""
        self.last_candidates = candidates
        self.last_truncated = candidates > self.capacity
        if candidates > self.MAX_CAPACITY:
            warn_capacity_ceiling(self, candidates)
        if self.adaptive_capacity:
            self.capacity = self._bucket(candidates)
        else:
            self.saturated = candidates >= self.capacity

    def _update_banded(self, counts: np.ndarray) -> None:
        """Capacity, compact capacity and band boundaries for the next
        frame, from this frame's counts (read back in one copy)."""
        g = self.n_bands
        candidates, totals = int(counts[0]), counts[1 : 1 + g]
        splats = counts[1 + g : 1 + 2 * g]
        self.last_candidates = candidates
        self.last_band_totals, self.last_band_splats = totals, splats
        if candidates > self.MAX_CAPACITY:
            warn_capacity_ceiling(self, candidates)
        band_max = int(totals.max())
        self.last_truncated = (band_max > self.capacity // g
                               or int(splats.max()) > self.compact_capacity // g)
        # Compacted-splat axis: grow if any band's in-band splat count
        # exceeds its share (same doubling semantics).
        if int(splats.max()) > self.compact_capacity // g:
            self.compact_capacity = self._round_banded(
                min(2 * self.compact_capacity, self.MAX_CAPACITY)
            )
        # Banded capacity saturates PER BAND at its share of the
        # MAX_CAPACITY clamp; the global candidates check above cannot see
        # a single hot band hitting that ceiling (rebalancing cannot split
        # a band below one tile row).
        ceiling_per_band = self._round_banded(self.MAX_CAPACITY) // g
        if self.adaptive_capacity:
            self.capacity = self._bucket_banded(band_max)
            if band_max > ceiling_per_band:
                warn_capacity_ceiling(self, band_max * g)
        else:
            self.saturated = band_max >= self.capacity // g
            if self.saturated and self.capacity // g >= ceiling_per_band:
                warn_capacity_ceiling(self, band_max * g)
        self._rebalance_bands(totals)

    # ------------------------------------------------------------------
    # Profiling mode: the frame record's stages, under the reference's names.
    # ------------------------------------------------------------------

    def last_record(self) -> Optional[Dict]:
        """The last frame's record (telemetry.summary: method, host ms of
        its spans, device ms of its stages, counters), or None before the
        first frame.  On the card it reads the frame's stamps back."""
        rec = self._record.last()
        return None if rec is None else telemetry.summary(rec)

    def profile_frame(self, camera: Camera, *, warmup: bool = False) -> Dict[str, float]:
        """Render ``camera`` and return its stages' ms, from the frame
        record's device stamps (the host clock on the CPU), under the
        reference's names (STAGE_NAMES; stage A only where the scene has
        SH), as the reference's CudaTimer brackets them
        (Utilities.h:155-187, Demo.cpp:432-476).  The frame runs as any
        other, through the graph cache.  ``warmup`` renders (and drops)
        one frame first."""
        if warmup:
            self.render(camera)
        self.render(camera)
        record = self.last_record()["stage_ms"]
        stages = {name: record[name] for name in STAGE_NAMES}
        if self.scene.sh is None or self.scene.sh_degree <= 0:
            stages.pop("evaluateSphericalHarmonics")
        for name, t in stages.items():
            self.stats[name] += t
        self.profiled_count += 1
        return stages

    def report(self) -> str:
        """Exit-time style averages report (Demo.cpp:541-562), over the
        frames timed by profile_frame()."""
        n = max(1, self.profiled_count)
        lines = []
        total = 0.0
        for name in STAGE_NAMES:
            avg = self.stats[name] / n
            lines.append(f"{name} average time ms: {avg:2.6f}")
            if name != "evaluateSphericalHarmonics":
                total += avg
        lines.append(f"Total average time ms: {total:2.6f}")
        return "\n".join(lines)
