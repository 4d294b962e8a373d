"""Frame pipeline orchestration.

One frame runs six stages on one device, with no host synchronization
inside the frame:

  A  ops.sh.evaluate_sh_colors          (torch)
  B  ops.projection.project_splats      (torch)
  C  ops.binning.build_tile_pairs       (torch, then kernels K2 + K3)
  D  ops.sorting.sort_pairs             (torch.sort)
  E  ops.ranges.tile_ranges             (kernel K1)
  F  ops.raster.rasterize_tiles         (kernel K4), then tiles_to_image

The only optional readback is the candidate-pair count used for capacity
management, which mirrors the reference's saturation doubling
(Demo.cpp:356-366, cu:700-703): when a frame's candidate count exceeds the
list capacity, that frame renders with a truncated list and the next one
gets more capacity.

Entry points run on the card unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

import time
import warnings
from typing import Dict, Tuple

import numpy as np
import torch

from .config import RenderConfig
from .models.camera import Camera
from .models.scene import GaussianScene
from .ops.binning import build_tile_pairs
from .ops.expand import MAX_BLOCK as _EMIT_BLOCK
from .ops.expand import MAX_CAPACITY as _MAX_CAPACITY
from .ops.expand import PREP_BLK as _PREP_BLK
from .ops.projection import project_splats
from .ops.ranges import tile_ranges
from .ops.raster import pack_pair_data, rasterize_tiles, tiles_to_image
from .ops.sh import evaluate_sh_colors
from .ops.sorting import sort_pairs
from .utils.device import resolve_device

# Emit blocks per capacity grain on the card (whole 4096-slot groups, the
# JAX package's grid-step grain, so both packages size lists alike).
_CUDA_GRAIN_BLOCKS = 4

_BANDED_MSG = (
    "sort_bands > 1 (the banded path) is not ported yet: see ROADMAP.md, "
    "queue 1, item 13"
)

_CAMERA_FIELDS = (
    ("view", (4, 4)),
    ("position", (3,)),
    ("fov_cotangent", (2,)),
    ("depth_scale_bias", (2,)),
    ("aspect", ()),
)


def camera_tensors(camera_data: dict, device) -> Dict[str, torch.Tensor]:
    """Camera.camera_data() (NumPy) -> float32 tensors on ``device``, in
    one host-to-device copy."""
    flat = np.concatenate(
        [np.asarray(camera_data[k], np.float32).reshape(-1) for k, _ in _CAMERA_FIELDS]
    )
    t = torch.from_numpy(flat).to(device)
    out, off = {}, 0
    for k, shape in _CAMERA_FIELDS:
        n = int(np.prod(shape))
        out[k] = t[off : off + n].reshape(shape)
        off += n
    return out


def _splat_colors(scene: GaussianScene, cam: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Stage A: per-frame view-dependent colors when the scene has SH,
    otherwise the baked import-time colors (Demo.cpp:432-436)."""
    if scene.sh is not None and scene.sh_degree > 0:
        return evaluate_sh_colors(scene.means, scene.sh, cam["position"], scene.sh_degree)
    return scene.colors


def round_capacity(capacity: int, device=None) -> int:
    """Round a pair-list capacity up to the emit grain: 4096 slots on the
    card, 128 on the CPU (the JAX package's grain in interpret mode, so
    the CPU tests get the same slot arrays as the JAX tests)."""
    dev = torch.device("cuda" if device is None else device)
    grain = _EMIT_BLOCK * _CUDA_GRAIN_BLOCKS if dev.type == "cuda" else 128
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
        "viewport, opacity-aware extents), or render in tile-row bands via "
        "render.render_frame_multipass (n_passes x capacity_per_pass "
        "effective capacity).",
        RuntimeWarning,
        stacklevel=3,
    )


def _frame_pairs(scene, cam, config, capacity, row_band=None):
    """Stages A-E: (pairs, sorted attribute words, starts, counts)."""
    colors = _splat_colors(scene, cam)
    clip = project_splats(
        scene.means, scene.scales, scene.quats, cam, config, opacities=scene.opacities
    )
    pairs = build_tile_pairs(
        clip, colors, scene.opacities, config, capacity, row_band=row_band
    )
    sorted_keys, _, sorted_attrs = sort_pairs(pairs, stable=config.stable_sort)
    starts, counts = tile_ranges(sorted_keys, config)
    return pairs, sorted_attrs, starts, counts


def render_frame(
    scene: GaussianScene,
    camera_data: dict,
    config: RenderConfig,
    capacity: int,
    *,
    device=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Render one frame on ``device`` (default: the card).

    Returns (image uint8 [H, W, 4] tensor on the device, aux dict with the
    scalar tensors ``num_candidates`` and ``num_pairs``).
    """
    if config.sort_bands > 1:
        raise NotImplementedError(_BANDED_MSG)
    dev = resolve_device(device)
    capacity = round_capacity(capacity, dev)
    scene = scene.to(dev)
    cam = camera_tensors(camera_data, dev)
    pairs, sorted_attrs, starts, counts = _frame_pairs(scene, cam, config, capacity)
    pair_data = pack_pair_data(sorted_attrs, config.raster_chunk)
    tiles = rasterize_tiles(pair_data, starts, counts, config)
    image = tiles_to_image(tiles, config)
    return image, dict(num_candidates=pairs.num_candidates, num_pairs=pairs.num_pairs)


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
# (Demo.cpp:556-562), for comparable profiling reports.
STAGE_NAMES = (
    "evaluateSphericalHarmonics",
    "evaluateClipData",
    "buildTileList",
    "sortTileList",
    "evaluateTileRanges",
    "renderDepthBuffer",
)


class Renderer:
    """Stateful host-side renderer: capacity management and optional
    per-stage profiling, on one device (default: the card)."""

    # Hard capacity ceiling: prefix sums travel as exact f32 integers.
    MAX_CAPACITY = _MAX_CAPACITY

    def __init__(self, scene: GaussianScene, config: RenderConfig = RenderConfig(), *,
                 device=None):
        if config.sort_bands > 1:
            raise NotImplementedError(_BANDED_MSG)
        self.config = config
        self.device = resolve_device(device)
        self.scene = scene.to(self.device).pad_to_multiple(_PREP_BLK)
        self.capacity = min(
            round_capacity(config.tile_capacity(self.scene.count), self.device),
            self.MAX_CAPACITY,
        )
        self.saturated = False
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

    @classmethod
    def _bucket(cls, candidates: int) -> int:
        """Capacity bucket: 8% headroom, 64Ki granularity."""
        want = max(1 << 17, int(candidates * 1.08))
        grain = 1 << 16
        return min(-(-want // grain) * grain, cls.MAX_CAPACITY)

    def render(self, camera: Camera, *, check_saturation: bool = True) -> np.ndarray:
        """Render and return a [H, W, 4] uint8 numpy image.

        ``check_saturation`` reads the candidate count back to the host
        and resizes the pair-list capacity for the NEXT frame; the current
        frame renders with a truncated list if it overflowed.
        """
        if self.saturated:
            # Demo.cpp:356-366 grow-on-saturation behavior.
            self.capacity = min(self.capacity * 2, self.MAX_CAPACITY)
            self.saturated = False
        image, aux = render_frame(
            self.scene, camera.camera_data(), self.config, self.capacity,
            device=self.device,
        )
        self.frame_count += 1
        if check_saturation:
            candidates = int(aux["num_candidates"])
            self.last_candidates = candidates
            if candidates > self.MAX_CAPACITY:
                warn_capacity_ceiling(self, candidates)
            if self.adaptive_capacity:
                self.capacity = self._bucket(candidates)
            else:
                self.saturated = candidates >= self.capacity
        return image.cpu().numpy()

    # ------------------------------------------------------------------
    # Profiling mode: stage-sliced timing with reference-matching names.
    # ------------------------------------------------------------------

    def profile_frame(self, camera: Camera, *, warmup: bool = False) -> Dict[str, float]:
        """Time each pipeline stage (ms), with CUDA events on the card and
        the host clock on the CPU.  Like the reference's CudaTimer
        bracketing (Utilities.h:155-187, Demo.cpp:432-476) the stages run
        back to back, one after the other.  ``warmup`` runs (and drops)
        one untimed pass first."""
        if warmup:
            self._time_stages(camera)
        stages = self._time_stages(camera)
        for name, t in stages.items():
            self.stats[name] += t
        self.profiled_count += 1
        return stages

    def _time_stages(self, camera: Camera) -> Dict[str, float]:
        scene, cfg = self.scene, self.config
        cap = round_capacity(self.capacity, self.device)
        cam = camera_tensors(camera.camera_data(), self.device)
        has_sh = scene.sh is not None and scene.sh_degree > 0
        cuda = self.device.type == "cuda"
        marks = []

        def mark():
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append(ev)
            else:
                marks.append(time.perf_counter())

        mark()
        colors = _splat_colors(scene, cam)
        mark()
        clip = project_splats(
            scene.means, scene.scales, scene.quats, cam, cfg, opacities=scene.opacities
        )
        mark()
        pairs = build_tile_pairs(clip, colors, scene.opacities, cfg, cap)
        mark()
        keys, _, attrs = sort_pairs(pairs, stable=cfg.stable_sort)
        mark()
        starts, counts = tile_ranges(keys, cfg)
        mark()
        rasterize_tiles(pack_pair_data(attrs, cfg.raster_chunk), starts, counts, cfg)
        mark()
        if cuda:
            torch.cuda.synchronize(self.device)
            ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        else:
            ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        stages = dict(zip(STAGE_NAMES, ms))
        if not has_sh:
            stages.pop("evaluateSphericalHarmonics")
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
