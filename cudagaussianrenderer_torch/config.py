"""Render configuration.

The same frozen dataclass as ``cudagaussianrenderer_tpu.config``, with the
same fields, validation and derived properties, so both packages accept
exactly the same configurations.  The limits that came from the TPU
(<= 255 tiles per axis, ``raster_chunk`` a power-of-two multiple of 128,
the automatic switch to ``depth_bits=32`` above 8191 tiles) are kept:
the port's kernels reproduce the JAX package's outputs slot for slot, and
its packed layouts rely on them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration of the rendering pipeline.

    Defaults reproduce the CUDA reference exactly:
    1024x1024 screen, 16px tiles (=> 64x64 = 4096 tiles), Gaussian falloff
    with a 3-sigma confidence ellipse, tile-list capacity of 8 entries per
    splat, early saturation exit at transmittance 0.02.
    """

    # --- framebuffer geometry (reference: Consts.h:4-7) ---
    # The reference hardcodes a square 1024 screen; here width and height
    # are independent.  screen_size is the width (and the height when
    # screen_height is None).
    screen_size: int = 1024
    screen_height: Optional[int] = None
    tile_size: int = 16

    # --- splat falloff kernel (reference: GaussianRender.cu:8-9, 298-302, 977-981) ---
    # "gaussian": density = exp(-dx/2), ellipse extent = 3 * sqrt(lambda)
    # "epanechnikov": density = 1 - dx/7, ellipse extent = sqrt(7) * sqrt(lambda)
    falloff: str = "gaussian"

    # --- splat extents ---
    # Opacity-aware confidence-ellipse truncation.  The reference always
    # uses the full 3-sigma ellipse (GaussianRender.cu:295-302), but a
    # splat with opacity alpha contributes more than the 8-bit output
    # floor (1/255) only where alpha * density > 1/255, i.e. within
    # r(alpha) = sqrt(2 ln(255 alpha)) sigma <= 3 sigma (gaussian; the
    # Epanechnikov analog is sqrt(1 - 1/(255 alpha)) of the sqrt(7)
    # support).  Truncating low-opacity splats to that radius cuts the
    # emitted pair count — every post-binning stage costs O(pairs) — with
    # per-splat pixel error bounded below one output level.  False
    # restores the reference's exact fixed-sigma extents.
    opacity_aware_extents: bool = True
    # Pixel-center-aware strip runs.  Pixels sample at integer
    # coordinates (clip = px * 2/S - 1, no half-texel offset,
    # GaussianRender.cu:933-939), so a tile the ellipse grazes only in
    # the last ~1 px before a pixel row/column has NO pixel center
    # inside the (opacity-truncated) support: every contribution is
    # below the 8-bit output floor.  Emitting only tiles whose
    # pixel-center span intersects the ellipse cuts ~6% of pairs at the
    # bench workload (round-5 PERF_NOTES) with the same sub-LSB error
    # class as opacity_aware_extents.  False restores the reference's
    # tile-rect overlap semantics (its exact test keeps the grazers,
    # cu:375-405).
    center_sampled_runs: bool = True

    # --- tile list ---
    # Initial capacity = capacity_factor * splat_count (reference: Demo.cpp:325).
    capacity_factor: int = 8
    # Explicit capacity override (entries).  None -> capacity_factor * count
    # rounded up to a multiple of 1024.
    capacity: Optional[int] = None

    # --- sort semantics ---
    # Stable sorting preserves emission (= splat index) order among
    # equal-key pairs, making tie blending bit-reproducible across list
    # layouts — at a measured 26% cost on the whole sort stage (XLA
    # augments keys with indices).  The default (False) is still
    # deterministic run-to-run and matches the reference more closely:
    # CUDA's tie order depends on block scheduling (cu:672-712).
    stable_sort: bool = False

    # --- band-segmented sort ---
    # G > 1 emits the pair list band-major over G tile-row bands (an
    # in-frame compaction gathers each band's splats, ops/banded.py) and
    # sorts it as a batched [G, capacity/G] torch.sort, one segment per
    # band, with per-band saturation.  It adds [G, N] prefix work to stage
    # C and saves only sort passes: at 1M splats, 1024x1024 and G = 16 the
    # banded frame took 1.0-1.5x the flat frame's time in the same run on
    # an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 5).  It is kept as
    # a correct, tested formulation.  0/1 = flat sort, the default (the
    # reference's single cub dispatch, GaussianRender.cu:804-855).
    sort_bands: int = 0

    # --- multi-chip band balancing ---
    # Tile-row-sharded rendering (parallel.distributed) assigns each
    # device a contiguous band of tile rows.  False: uniform bands of
    # tiles_y / n_devices rows.  True: per-frame equal-WORK bands — band
    # boundaries are chosen inside the compiled program from a weighted
    # per-row candidate histogram so every device sorts/rasterizes a
    # near-equal share of the pair list (bounded at 2x the uniform row
    # count).  Recovers the skew tax on real scenes (the worst uniform
    # band carries ~35% of the pairs at 4 devices on the bench scene);
    # costs one image-sized psum_scatter to reassemble rows.  Single
    # device: no effect.
    balanced_bands: bool = False

    # --- sort key layout ---
    # Number of bits of quantized linear depth carried in the sort key.
    # 19 (default): a single uint32 key packs (tile_id << 19) | depth19 —
    #   single-operand sort.
    # 32: two-operand lexicographic (tile, depth32) sort matching the
    #   reference's full 32-bit depth precision (GaussianRender.cu:446-454).
    depth_bits: int = 19

    # --- rasterization ---
    # Pairs between two early-exit votes of the raster kernel; must be a
    # power-of-two multiple of 128.  Chunks are aligned to multiples of
    # raster_chunk in the sorted pair list, so both packages exit after
    # the same pairs.  The reference's analog is its 32-wide warp chunk
    # (GaussianRender.cu:950).
    raster_chunk: int = 128
    # Tile is considered opaque when every pixel transmittance <= this
    # (reference: GaussianRender.cu:995).
    transmittance_eps: float = 0.02
    # Optional gamma on output (the reference ships it commented out,
    # GaussianRender.cu:1001-1005).
    gamma: Optional[float] = None
    # Optional opaque background color (r, g, b) in [0, 1], composited
    # under the blended splats with the pixel's remaining transmittance:
    # out = rgb + T * background.  None reproduces the reference exactly
    # (black frame clear, Demo.cpp:399; alpha 255 only on covered
    # tiles).  The 3DGS evaluation protocol renders over white/black —
    # (1, 1, 1) gives the white variant.  Saturation-exited pixels carry
    # T <= transmittance_eps, so background leakage there is below the
    # same 2% the reference's early exit accepts.
    background: Optional[tuple] = None
    # Tiles per raster grid cell in the JAX package.  The CUDA raster
    # kernel runs one block per tile and ignores it; it is kept, with its
    # validation, so both packages accept the same configurations.
    tiles_per_cell: Optional[int] = None

    # --- numerics (reference: GaussianRender.cu:267-307) ---
    # Epsilon guarding the eigenvalue radius and conic inverse determinant.
    epsilon: float = 1e-12

    def __post_init__(self):
        if self.screen_size % self.tile_size != 0:
            raise ValueError("screen_size must be a multiple of tile_size")
        if self.screen_h % self.tile_size != 0:
            raise ValueError("screen_height must be a multiple of tile_size")
        if self.tiles_x > 255 or self.tiles_y > 255:
            # Tile coordinates pack as (x0*256 + y0)*256 + w in one exact
            # f32 (< 2^24) during list expansion; 255 tiles = 4080 px.
            raise ValueError("screens larger than 255 tiles per axis unsupported")
        if self.falloff not in ("gaussian", "epanechnikov"):
            raise ValueError(f"unknown falloff kernel {self.falloff!r}")
        if self.background is not None:
            bg = tuple(float(c) for c in self.background)
            if len(bg) != 3 or not all(0.0 <= c <= 1.0 for c in bg):
                raise ValueError("background must be 3 floats in [0, 1]")
            object.__setattr__(self, "background", bg)
        if self.depth_bits not in (19, 32):
            raise ValueError("depth_bits must be 19 (packed u32) or 32 (lex)")
        # The packed single-u32 key is (tile_id << 19) | depth19; the max
        # valid key ((T-1) << 19 | 0x7FFFF) must stay below the 0xFFFFFFFF
        # sentinel, i.e. total_tiles <= 8191.  Larger screens silently
        # wrapped tile ids before; auto-select the two-operand
        # lexicographic (tile, depth) sort instead.
        if self.depth_bits == 19 and self.total_tiles > 8191:
            object.__setattr__(self, "depth_bits", 32)
        if self.tiles_per_cell is not None:
            if self.total_tiles % self.tiles_per_cell != 0:
                raise ValueError("tiles_per_cell must divide the tile count")
        if (
            self.raster_chunk < 128
            or self.raster_chunk % 128 != 0
            or self.raster_chunk & (self.raster_chunk - 1)
        ):
            raise ValueError("raster_chunk must be a power-of-two multiple of 128")
        if self.tiles_per_cell is not None and self.tiles_per_cell < 1:
            raise ValueError("tiles_per_cell must be >= 1")
        if self.sort_bands < 0 or self.sort_bands > self.tiles_y:
            raise ValueError("sort_bands must be in [0, tiles_y]")

    # --- derived quantities ---
    @property
    def screen_w(self) -> int:
        return self.screen_size

    @property
    def screen_h(self) -> int:
        return self.screen_height if self.screen_height is not None else self.screen_size

    @property
    def aspect(self) -> float:
        """Width / height — what Camera.aspect should be for this screen."""
        return self.screen_w / self.screen_h

    @property
    def tiles_x(self) -> int:
        """Tiles along the screen width (reference: Consts.h:6)."""
        return self.screen_w // self.tile_size

    @property
    def tiles_y(self) -> int:
        """Tiles along the screen height."""
        return self.screen_h // self.tile_size

    @property
    def tiles_per_screen(self) -> int:
        """Square-screen alias for tiles_x (reference: Consts.h:6)."""
        return self.tiles_x

    @property
    def total_tiles(self) -> int:
        """Total tile count (reference: Consts.h:7)."""
        return self.tiles_x * self.tiles_y

    def cell_tiles(self, num_tiles: Optional[int] = None) -> int:
        """Raster tiles per grid cell for a ``num_tiles`` grid (default:
        the full screen), as the JAX package computes it.  An explicit
        ``tiles_per_cell`` is honored strictly; the None default
        auto-selects the largest of 16/8/4/2/1 that divides
        ``num_tiles``."""
        t = self.total_tiles if num_tiles is None else num_tiles
        if self.tiles_per_cell is not None:
            return self.tiles_per_cell
        return next(d for d in (16, 8, 4, 2, 1) if t % d == 0)

    @property
    def pixels_per_tile(self) -> int:
        return self.tile_size**2

    @property
    def sigma_factor(self) -> float:
        """Confidence-ellipse radius in units of sqrt(eigenvalue).

        3-sigma for the Gaussian falloff; sqrt(7) for Epanechnikov, whose
        density 1 - dx/7 reaches zero at dx = 7
        (reference: GaussianRender.cu:295-302).
        """
        return 3.0 if self.falloff == "gaussian" else 7.0**0.5

    @property
    def sentinel_tile(self) -> int:
        """Tile id given to invalid tile-list entries so they sort last."""
        return self.total_tiles

    def tile_capacity(self, splat_count: int) -> int:
        """Tile-list capacity for a scene of ``splat_count`` splats."""
        if self.capacity is not None:
            return self.capacity
        cap = self.capacity_factor * splat_count
        return max(1024, -(-cap // 1024) * 1024)


# Camera defaults (reference: CameraControls.h:35-37).
DEFAULT_NEAR = 0.1
DEFAULT_FAR = 100.0
DEFAULT_FOV_Y_DEG = 60.0
