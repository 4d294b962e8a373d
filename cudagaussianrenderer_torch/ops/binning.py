"""Tile-list construction — stage C of the frame pipeline.

The reference builds the (tile, splat) pair list with persistent blocks,
warp scans and device-wide atomic appends (buildTileListKernel,
GaussianRender.cu:438-802).  The port keeps the JAX package's two-phase
formulation, because its output order is deterministic and the tests
hold the port to it slot for slot:

  1. per-splat exact candidate counts: the ellipse AABB in tile space
     (cu:526-551) refined to exact per-tile-row x-runs (splat_row_packs),
     then an inclusive prefix sum;
  2. emission (ops.expand): splat i owns slots [excl_i, incl_i) of a
     fixed-capacity list and writes its pairs there; slots past the
     total become sentinel entries that sort to the end.

Overflow behaves like the reference's saturation (cu:700-703,
Demo.cpp:356-366): candidates beyond capacity are dropped for this frame
and render.Renderer grows the capacity for the next one.

Sort keys: tile-major, front-to-back depth minor (getKey, cu:446-454).
The default packs (tile_id << 19) | depth19 into one 32-bit key;
``depth_bits=32`` carries (tile, depth24 << 8) as two words.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import RenderConfig
from .geometry import pack_rgb_u32
from .projection import SplatClipData

DEPTH_BITS_PACKED = 19
SENTINEL_KEY_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Phase 1: per-splat candidate tile rects + counts (cu:526-551)
# ---------------------------------------------------------------------------

class TileRects(NamedTuple):
    x0: torch.Tensor      # [N] int32 tile-space rect min x (clamped)
    y0: torch.Tensor      # [N]
    w: torch.Tensor       # [N] rect width in tiles (>= 0)
    h: torch.Tensor       # [N] rect height in tiles (>= 0)
    counts: torch.Tensor  # [N] candidate tiles = max(0, w*h)


def _floor_i32(x: torch.Tensor) -> torch.Tensor:
    return torch.floor(x).to(torch.int32)


def _ceil_i32(x: torch.Tensor) -> torch.Tensor:
    return torch.ceil(x).to(torch.int32)


def _bound(b):
    """A band bound as the clamp takes it: a tensor as it is, else an int."""
    return b if isinstance(b, torch.Tensor) else int(b)


def splat_tile_rects(
    clip_data: SplatClipData, config: RenderConfig, row_band=None
) -> TileRects:
    """Per-splat candidate tile rect (cu:526-551).

    ``row_band``, if given, is a (lo, hi) pair of tile-row bounds: rects
    are clamped to the band, so splats outside it emit zero candidates
    (render_frame_multipass renders one band per pass this way).  Each
    bound is an int or a 0-d int32 tensor on the clip data's device (a
    balanced band chosen on the device, read by no host).
    """
    tx, ty = config.tiles_x, config.tiles_y
    d = clip_data
    row_lo, row_hi = (0, ty) if row_band is None else (_bound(row_band[0]), _bound(row_band[1]))
    # AABB half-extent of the oriented ellipse (getAABBRect, cu:408-436).
    hx = torch.abs(d.cos_t * d.e0) + torch.abs(d.sin_t * d.e1)
    hy = torch.abs(d.sin_t * d.e0) + torch.abs(d.cos_t * d.e1)
    # Clip [-1,1] -> tile coords [0, tiles along the axis].
    sx = 0.5 * tx
    sy = 0.5 * ty
    x0 = torch.clamp(_floor_i32((d.cx - hx + 1.0) * sx), 0, tx)
    y0 = torch.clamp(_floor_i32((d.cy - hy + 1.0) * sy), row_lo, row_hi)
    x1 = torch.clamp(_ceil_i32((d.cx + hx + 1.0) * sx), 0, tx)
    y1 = torch.clamp(_ceil_i32((d.cy + hy + 1.0) * sy), row_lo, row_hi)
    w = x1 - x0
    h = y1 - y0
    counts = torch.clamp(w * h, min=0)
    return TileRects(x0=x0, y0=y0, w=w, h=h, counts=counts)


# ---------------------------------------------------------------------------
# Phase 1b: per-row exact x-ranges
# ---------------------------------------------------------------------------
#
# For one tile row (a horizontal strip) the tiles intersecting the convex
# ellipse form one contiguous x-run, and every tile in the run intersects,
# so emitting [floor(xlo), ceil(xhi)) per row reproduces the exact
# per-candidate test's pair set (cu:653-679) without testing candidates.
# With the ellipse parametrized p(u,v) = c + R(θ)·(e0·u, e1·v), the chord
# y - cy = k has x-extent k·M/ry² ± (e0·e1/ry)·√(1 - k²/ry²), with
# M = sinθcosθ(e0² - e1²) and ry² = (e0 sinθ)² + (e1 cosθ)²; the strip's
# maximum sits at k* = M/rx clamped into the strip (and symmetrically for
# the minimum).  Ranges round OUTWARD by STRIP_EPS so float rounding can
# only add a boundary-grazing tile, never drop one.

STRIP_EPS = 1e-5
# Per-row (dx, width) pairs pack as 6-bit fields, 2 rows per exact-f32
# carrier, 4 carriers = 8 rows; wider rects fall back to full-rect
# emission, taller ones emit full-width rows past the eighth.
MAX_PACK_ROWS = 8
MAX_PACK_W = 63


class RowPacks(NamedTuple):
    packs: Tuple[torch.Tensor, ...]  # 4 x [N] f32: rows 2p/2p+1 (dx,w) 6-bit fields
    counts: torch.Tensor             # [N] int32 exact candidate counts


def splat_row_packs(
    clip_data: SplatClipData, rects: TileRects, config: RenderConfig
) -> RowPacks:
    """Exact per-tile-row x-ranges for the first MAX_PACK_ROWS rect rows.

    Returns packed (dx, w) pairs relative to the rect origin plus the
    exact per-splat candidate count the emit kernel maps slots with:
      * w ≤ 63, h ≤ 8:   count = Σ w_r                      (fully exact)
      * w ≤ 63, h > 8:   count = Σ w_r + (h - 8)·w          (rows 8+ full)
      * w > 63:          count = h·w, all w_r = 0           (full rect)
    """
    d = clip_data
    tch = 2.0 * config.tile_size / config.screen_h
    sx = 0.5 * config.tiles_x
    ct, st, e0, e1 = d.cos_t, d.sin_t, d.e0, d.e1
    a_ = e0 * st
    b_ = e1 * ct
    m = ct * st * (e0 * e0 - e1 * e1)
    ry2 = a_ * a_ + b_ * b_
    ry = torch.sqrt(ry2)
    rx = torch.sqrt(e0 * e0 * ct * ct + e1 * e1 * st * st)
    kstar = m / torch.clamp(rx, min=1e-30)
    inv_ry2 = 1.0 / torch.clamp(ry2, min=1e-30)
    p_inv_ry = (e0 * e1) / torch.clamp(ry, min=1e-30)
    slope = m * inv_ry2

    x0f = rects.x0.to(torch.float32)
    y0f = rects.y0.to(torch.float32)
    x1f = x0f + rects.w.to(torch.float32)
    hf = rects.h.to(torch.float32)
    packable = rects.w <= MAX_PACK_W

    # Pixel-center-aware runs (config.center_sampled_runs): a tile's pixel
    # centers span [16t, 16t + 15] px per axis, so the strip's k-interval
    # ends 1/16 row early and the x-run keeps a tile iff its CENTER span
    # touches the ellipse.
    centered = config.center_sampled_runs
    y_span = (15.0 / 16.0) * tch if centered else tch

    def clip_t(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    packs = []
    count_f = torch.zeros_like(x0f)
    pack = None
    for r in range(MAX_PACK_ROWS):
        ya = (y0f + float(r)) * tch - 1.0
        yb = ya + y_span
        da, db = ya - d.cy, yb - d.cy
        ka = clip_t(da, -ry, ry)
        kb = clip_t(db, -ry, ry)
        khi = clip_t(kstar, ka, kb)
        klo = clip_t(-kstar, ka, kb)
        s_hi = p_inv_ry * torch.sqrt(torch.clamp(1.0 - khi * khi * inv_ry2, min=0.0))
        s_lo = p_inv_ry * torch.sqrt(torch.clamp(1.0 - klo * klo * inv_ry2, min=0.0))
        xhi = d.cx + khi * slope + s_hi
        xlo = d.cx + klo * slope - s_lo
        live = (
            (da <= ry + STRIP_EPS)
            & (db >= -(ry + STRIP_EPS))
            & (float(r) < hf)
            & packable
        )
        if centered:
            # Keep tile t iff its center span [t, t + 15/16] (tile units)
            # intersects [xlo, xhi].
            xl_t = clip_t(
                torch.ceil((xlo - STRIP_EPS + 1.0) * sx - 15.0 / 16.0), x0f, x1f
            )
            xh_t = clip_t(
                torch.floor((xhi + STRIP_EPS + 1.0) * sx) + 1.0, x0f, x1f
            )
        else:
            xl_t = clip_t(torch.floor((xlo - STRIP_EPS + 1.0) * sx), x0f, x1f)
            xh_t = clip_t(torch.ceil((xhi + STRIP_EPS + 1.0) * sx), x0f, x1f)
        w_r = torch.where(live, torch.clamp(xh_t - xl_t, min=0.0), 0.0)
        dx_r = torch.where(w_r > 0, xl_t - x0f, 0.0)
        count_f = count_f + w_r
        if r % 2 == 0:
            pack = (dx_r * 64.0 + w_r) * 4096.0
        else:
            packs.append(pack + dx_r * 64.0 + w_r)
    wf = rects.w.to(torch.float32)
    overflow_rows = torch.where(
        packable, torch.clamp(hf - float(MAX_PACK_ROWS), min=0.0), hf
    )
    count_f = count_f + overflow_rows * wf
    return RowPacks(
        packs=tuple(packs), counts=torch.clamp(count_f, min=0.0).to(torch.int32)
    )


# ---------------------------------------------------------------------------
# Sort keys (getKey, cu:446-454)
# ---------------------------------------------------------------------------

def quantize_depth(clip_z: torch.Tensor, bits: int) -> torch.Tensor:
    """Clip depth [-1, 1] -> int64 with ``bits`` significant bits."""
    z01 = torch.clamp((clip_z + 1.0) * 0.5, 0.0, 1.0)
    return (z01 * float(2**bits - 1)).to(torch.int64)


class TilePairs(NamedTuple):
    """Fixed-capacity pair list with sentinel padding.

    Every word is an int32 tensor holding the uint32 bit pattern of the
    JAX package's operand.  ``attrs`` carries the raster attributes as
    three words (center 16+16 fixed point, conic a12|c12|rho8,
    rgb888|alpha8) that the sort moves with the keys, so the rasterizer
    needs no gather.
    """

    keys: Tuple[torch.Tensor, ...]  # 1 word (packed) or 2 (lex: tile, depth)
    values: torch.Tensor            # [C] int32 splat indices (-1 = invalid)
    attrs: Tuple[torch.Tensor, ...]  # 3 words: cxcy, conic, rgba
    num_candidates: torch.Tensor    # scalar int32: total exact-range candidates
    num_pairs: torch.Tensor         # scalar int32: candidates within capacity


def pack_columns(
    clip_data: SplatClipData,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    config: RenderConfig,
    rects: TileRects,
    row_packs: RowPacks,
):
    """The 13 flat [N] f32 per-splat columns of the emit kernels, in R_*
    order without R_IDX."""
    depth_bits = (
        DEPTH_BITS_PACKED if config.depth_bits == DEPTH_BITS_PACKED else 24
    )
    qdepth = quantize_depth(clip_data.clip_z, depth_bits)
    rgb_u32 = pack_rgb_u32(colors)
    # Tile rect packed into one exact-f32 value: (x0*256 + y0)*256 + w,
    # all components <= 255 (config caps tiles per axis) so < 2^24.
    geom = (
        (rects.x0.to(torch.float32) * 256.0 + rects.y0.to(torch.float32)) * 256.0
        + rects.w.to(torch.float32)
    )
    return (
        geom,
        qdepth.to(torch.float32),          # < 2^24, exact in f32
        clip_data.cx,
        clip_data.cy,
        clip_data.con_a,
        clip_data.con_b,
        clip_data.con_c,
        rgb_u32.to(torch.float32),         # < 2^24, exact in f32
        opacities,
        *row_packs.packs,                  # 4 rows of (dx, w) 6-bit fields
    )


def columns_and_counts(
    clip_data: SplatClipData,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    config: RenderConfig,
    *,
    row_band=None,
):
    """Rects and row packs, in torch: (the 13 flat [N] f32 columns of
    pack_columns, [N] int32 exact candidate counts).  The plain version of
    the binning half of ops.splat.splat_columns' kernel."""
    rects = splat_tile_rects(clip_data, config, row_band=row_band)
    row_packs = splat_row_packs(clip_data, rects, config)
    return pack_columns(clip_data, colors, opacities, config, rects, row_packs), row_packs.counts


def emit_columns(
    clip_data: SplatClipData,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    config: RenderConfig,
    *,
    row_band=None,
):
    """columns_and_counts with the candidate prefix sum: the inputs of
    ops.expand.emit_pairs — (13 flat [N] f32 columns in R_* order without
    R_IDX, [N] int32 inclusive candidate prefix)."""
    cols, counts = columns_and_counts(clip_data, colors, opacities, config, row_band=row_band)
    return cols, torch.cumsum(counts, 0, dtype=torch.int32)


def build_tile_pairs_from_columns(cols, counts: torch.Tensor, capacity: int,
                                  config: RenderConfig) -> TilePairs:
    """The fixed-capacity pair list of a frame's per-splat columns and
    exact candidate counts (columns_and_counts, or ops.splat.splat_columns):
    their prefix sum, then ops.expand.emit_pairs (kernels K2 and K3) for
    the slot arrays."""
    from .expand import (
        OUT_CONIC,
        OUT_CXCY,
        OUT_KEY0,
        OUT_KEY1,
        OUT_RGBA,
        OUT_VALUES,
        emit_pairs,
    )

    incl = torch.cumsum(counts, 0, dtype=torch.int32)
    total = incl[-1]
    out = emit_pairs(cols, incl, capacity, config)

    attrs = (out[OUT_CXCY], out[OUT_CONIC], out[OUT_RGBA])
    if config.depth_bits == DEPTH_BITS_PACKED:
        keys = (out[OUT_KEY0],)
    else:
        keys = (out[OUT_KEY0], out[OUT_KEY1])

    return TilePairs(
        keys=keys,
        values=out[OUT_VALUES],
        attrs=attrs,
        num_candidates=total,
        # Emission fills exactly the slots below min(total, capacity).
        num_pairs=torch.clamp(total, max=capacity),
    )


def build_tile_pairs(
    clip_data: SplatClipData,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    config: RenderConfig,
    capacity: int,
    *,
    row_band=None,
) -> TilePairs:
    """The fixed-capacity pair list: columns_and_counts, then
    build_tile_pairs_from_columns."""
    cols, counts = columns_and_counts(clip_data, colors, opacities, config, row_band=row_band)
    return build_tile_pairs_from_columns(cols, counts, capacity, config)
