"""Tile rasterizer — stage F, on kernel K4 (raster).

The reference rasterizes one 16x16 tile per thread block, one thread per
pixel, staging splat chunks through shared memory and blending front to
back with a cooperative early-saturation exit (rasterizeTilesKernel,
GaussianRender.cu:908-1034).  The port's kernel (csrc/raster.cu) keeps
that shape, fed by the sorted, packed attribute words the sort carried
with the keys (no gather):

  * four neighbouring pixels of a tile row per thread (one where 4 does
    not divide the tile edge); a tile of up to 1,024 pixels is one block,
    a larger one a thread-block cluster of Hopper, a band of the tile's
    rows a block (``raster_geometry``), so every tile size the config
    accepts renders with its pixels in registers (up to 256x256, or
    128x128 at one pixel a group; beyond that a block loops over its
    band's groups, their state kept in the output between batches); each
    block stages the tile's [start, start + count) segment 128 pairs at a
    time in shared memory, decoded once per pair, the next batch in
    flight while this one blends, and every pixel blends them in order;
  * the clusters take the tiles longest list first (an argsort of the
    counts), so that no long list is left to run alone at the end;
  * after each whole ``raster_chunk`` of the sorted list (chunks aligned
    to multiples of raster_chunk, as the JAX kernel streams them) the
    tile votes (a cluster's blocks through distributed shared memory),
    and stops once every pixel's transmittance is <= transmittance_eps —
    so it exits after the same pairs as the JAX kernel;
  * channel 3 is tile coverage, or the pixel's transmittance when a
    background is set;
  * where the caller passes a counter, each tile adds the pairs it
    blended before its exit with one atomic (a frame's pairs blended,
    which Renderer reads back with its counts).

The JAX kernel blends a chunk at a time with a log-domain scan of one
bf16 limb (ops/raster.py:65-81 there); this kernel multiplies the
transmittance pair by pair in f32, with alpha = 2^min(m, log2 opacity)
from one ex2.approx of a conic that carries log2(e).  The frames differ by
the scan's rounding, which the JAX package bounds at 4 output LSB.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..config import RenderConfig
from ..utils import cuda_build as cb
from .geometry import as_u32_i64, unpack_conic_u32

# Streaming-buffer row layout ([4, C] planar; row 3 is zero padding).
ROW_CXCY = 0                # (x16 << 16 | y16) fixed point
ROW_CONIC = 1               # a_mf12 | c_mf12 | rho8 (geometry.pack_conic_u32)
ROW_RGBA = 2                # 0xRRGGBBAA
PAIR_ROWS = 4

CENTER_INV_SCALE = 2.0 / 65535.0

# K4's launch (csrc/raster.cu): a block has at most MAX_THREADS threads; a
# block of a cluster has CLUSTER_BLOCK_THREADS (3 to 8 warps) where the
# tile allows it; a cluster above PORTABLE_CLUSTER blocks needs the card's
# consent (gsr_raster_max_cluster), and MAX_CLUSTER is Hopper's largest.
MAX_THREADS = 1024
CLUSTER_BLOCK_THREADS = (96, 256)
PORTABLE_CLUSTER, MAX_CLUSTER = 8, 16


class RasterGeometry(NamedTuple):
    """K4's launch for one tile size: ``pixels`` of a tile row a thread
    blends (a group), ``cluster`` blocks a tile (1: one block, no cluster),
    ``band_rows`` tile rows a block (block r of a cluster takes rows
    [r * band_rows, (r + 1) * band_rows), the last band shorter where the
    edge asks for it) and ``threads`` a block.  A block whose band has more
    groups than threads loops over them, their state in the output."""

    pixels: int
    cluster: int
    band_rows: int
    threads: int


def raster_geometry(tile_size: int, cluster_cap: int = MAX_CLUSTER) -> RasterGeometry:
    """The geometry K4 launches at ``tile_size``.  A tile of up to
    MAX_THREADS pixels is one block, a thread a group.  A larger one is a
    cluster of 2 to ``cluster_cap`` blocks, each a band of rows: of the
    cluster sizes whose blocks hold their band in CLUSTER_BLOCK_THREADS
    threads, the one that leaves the fewest lanes of its warps idle (the
    short last band's included), the smaller block at a tie (more blocks an
    SM hide each other's barriers); where none does, ``cluster_cap``
    blocks, each covering its band's groups in equal turns of at most
    MAX_THREADS threads.  The kernel checks this and computes nothing else
    from the tile size."""
    px = 4 if tile_size % 4 == 0 else 1
    per_row = tile_size // px
    if tile_size * tile_size <= MAX_THREADS or cluster_cap < 2:
        cluster_cap = 1

    def split(cluster):
        band_rows = -(-tile_size // cluster)
        groups = band_rows * per_row
        turns = -(-groups // MAX_THREADS)
        return RasterGeometry(px, -(-tile_size // band_rows), band_rows, -(-groups // turns))

    lo, hi = CLUSTER_BLOCK_THREADS
    fitting = [g for g in map(split, range(2, cluster_cap + 1)) if lo <= g.threads <= hi]
    if not fitting:
        return split(cluster_cap)
    return min(fitting, key=lambda g: (g.cluster * 32 * -(-g.threads // 32), g.threads))


@functools.lru_cache(maxsize=None)
def max_cluster(device_index: int) -> int:
    """MAX_CLUSTER where the card runs a cluster of that many 1,024-thread
    K4 blocks, else PORTABLE_CLUSTER (the kernel asks the card once)."""
    with torch.cuda.device(device_index):
        got = cb.kernel("raster", "gsr_raster_max_cluster", [])()
    if got < 0:
        cb.check("raster", -got)
    return got


def pack_pair_data(sorted_attrs, chunk: int) -> torch.Tensor:
    """Sorted attribute words -> [PAIR_ROWS, C + 2*chunk] int32 buffer:
    the three words as rows, a zero row, and 2*chunk zero columns — the
    layout of the JAX package's pack_pair_data."""
    rows = torch.stack([a.to(torch.int32) for a in sorted_attrs])
    return torch.nn.functional.pad(rows, (0, 2 * chunk, 0, PAIR_ROWS - rows.shape[0]))


def _decode(words: torch.Tensor):
    """[3, ...] attribute words -> (cx, cy, na, nb2, nc, a_s, r, g, b)."""
    cxcy = as_u32_i64(words[ROW_CXCY])
    rgba = as_u32_i64(words[ROW_RGBA])
    cx = (cxcy >> 16).to(torch.float32) * CENTER_INV_SCALE - 1.0
    cy = (cxcy & 0xFFFF).to(torch.float32) * CENTER_INV_SCALE - 1.0
    con_a, con_b, con_c = unpack_conic_u32(words[ROW_CONIC])
    inv255 = 1.0 / 255.0
    a_s = (rgba & 0xFF).to(torch.float32) * inv255
    r = (rgba >> 24).to(torch.float32) * inv255
    g = ((rgba >> 16) & 0xFF).to(torch.float32) * inv255
    b = ((rgba >> 8) & 0xFF).to(torch.float32) * inv255
    return cx, cy, con_a * -0.5, -con_b, con_c * -0.5, a_s, r, g, b


def _raster_torch(pair_data, starts, counts, config: RenderConfig, num_tiles, row_offset,
                  blended=None):
    """Plain PyTorch version of K4 (see rasterize_tiles): the same
    per-pixel front-to-back recurrence, vectorized over the tiles still
    blending, one pair position at a time.  ``row_offset`` is an int or a
    0-d int32 tensor.  The pairs blended before the early exits are added
    into ``blended``, as the kernel adds them."""
    dev = pair_data.device
    ts = config.tile_size
    npix = ts * ts
    chunk = config.raster_chunk
    gauss = config.falloff == "gaussian"
    t = torch.arange(num_tiles, device=dev)
    pix = torch.arange(npix, device=dev)
    tile_x = (t % config.tiles_x)[:, None]
    tile_y = (t // config.tiles_x + row_offset)[:, None]
    pcx = (tile_x * ts + pix % ts).to(torch.float32) * (2.0 / config.screen_w) - 1.0
    pcy = (tile_y * ts + pix // ts).to(torch.float32) * (2.0 / config.screen_h) - 1.0

    starts = starts.to(torch.int64)
    counts = counts.to(torch.int64)
    ends = starts + counts
    astart = starts // chunk * chunk
    nchunks = torch.where(counts > 0, (ends - astart + chunk - 1) // chunk, 0)
    rgb = torch.zeros((num_tiles, npix, 3), dtype=torch.float32, device=dev)
    trans = torch.ones((num_tiles, npix), dtype=torch.float32, device=dev)
    active = nchunks > 0
    width = pair_data.shape[1]
    k = torch.arange(chunk, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    c = 0
    while True:
        idx_t = torch.nonzero(active & (c < nchunks)).flatten()
        if idx_t.numel() == 0:
            break
        pos = astart[idx_t, None] + c * chunk + k                    # [Ta, chunk]
        inseg = (pos >= starts[idx_t, None]) & (pos < ends[idx_t, None])
        count += inseg.sum()
        words = pair_data[:3, torch.clamp(pos, max=width - 1)]       # [3, Ta, chunk]
        cx, cy, na, nb2, nc, a_s, cr, cg, cbl = _decode(words)
        a_s = torch.where(inseg, a_s, 0.0)
        px, py = pcx[idx_t], pcy[idx_t]                               # [Ta, npix]
        acc, tr = rgb[idx_t], trans[idx_t]
        for i in range(chunk):
            dx = px - cx[:, i : i + 1]
            dy = py - cy[:, i : i + 1]
            m = (na[:, i : i + 1] * dx + nb2[:, i : i + 1] * dy) * dx + (nc[:, i : i + 1] * dy) * dy
            if gauss:
                density = torch.exp(torch.clamp(m, max=0.0))
            else:
                density = torch.clamp(1.0 + m * (2.0 / 7.0), 0.0, 1.0)
            alpha = a_s[:, i : i + 1] * density
            w = tr * alpha
            col = torch.stack([cr[:, i], cg[:, i], cbl[:, i]], dim=-1)[:, None, :]
            acc = acc + w[..., None] * col
            tr = tr * (1.0 - alpha)
        rgb[idx_t] = acc
        trans[idx_t] = tr
        # The vote after each whole chunk: stop once every pixel is opaque.
        active[idx_t] = (tr > config.transmittance_eps).any(dim=1)
        c += 1
    if blended is not None:
        blended += count.to(blended.dtype)
    if config.background is None:
        ch3 = (counts > 0).to(torch.float32)[:, None].expand(num_tiles, npix)
    else:
        ch3 = trans
    return torch.cat([rgb, ch3[..., None]], dim=-1)


def rasterize_tiles(
    pair_data: torch.Tensor,
    starts: torch.Tensor,
    counts: torch.Tensor,
    config: RenderConfig,
    *,
    num_tiles: int = None,
    tile_row_offset=0,
    blended: torch.Tensor = None,
) -> torch.Tensor:
    """K4: blend each tile's sorted pair segment.

    pair_data: [PAIR_ROWS, W] int32 from pack_pair_data.  starts, counts:
    [num_tiles] int32 from ops.ranges (or a tile-row band slice of them;
    ``tile_row_offset`` then shifts the pixel coordinates to the band's
    place on screen: an int, or a 0-d int32 tensor on the pairs' device,
    which the kernel reads from device memory, as the JAX kernel reads its
    SMEM scalar).  Returns [num_tiles, pixels_per_tile, 4] float32
    (r, g, b, coverage or transmittance).
    ``blended``, a [1] int32 tensor on the pairs' device, where given,
    gains the pairs the tiles blended before their exits: the pairs of
    each tile's segment in the raster_chunk windows it entered, the count
    the JAX kernel's batches define.
    Replaces ops/raster.py:_raster_kernel of the JAX package.
    """
    t = num_tiles if num_tiles is not None else config.total_tiles
    on_device = isinstance(tile_row_offset, torch.Tensor)
    row_offset = tile_row_offset if on_device else int(tile_row_offset or 0)
    if cb.dispatch_device(pair_data) == "cpu":
        return _raster_torch(pair_data, starts, counts, config, t, row_offset, blended)
    dev = pair_data.device
    cb.require(pair_data, "pair_data", torch.int32, dev)
    if pair_data.dim() != 2 or pair_data.shape[0] != PAIR_ROWS:
        raise ValueError(f"pair_data must be [{PAIR_ROWS}, W], got {tuple(pair_data.shape)}")
    cb.require(starts, "starts", torch.int32, dev, (t,))
    cb.require(counts, "counts", torch.int32, dev, (t,))
    if on_device:
        cb.require(row_offset, "tile_row_offset", torch.int32, dev, ())
    if blended is not None:
        cb.require(blended, "blended", torch.int32, dev, (1,))
    npix = config.pixels_per_tile
    out = torch.empty((t, npix, 4), dtype=torch.float32, device=dev)
    if t == 0:
        return out
    clustered = npix > MAX_THREADS
    geometry = raster_geometry(
        config.tile_size, max_cluster(dev.index) if clustered else MAX_CLUSTER)
    # A cluster a tile, the tiles longest list first (the one-block kernel
    # takes tile b in block b).
    order = torch.argsort(counts, descending=True).to(torch.int32) if clustered else None
    fn = cb.kernel("raster", "gsr_raster", RASTER_ARGTYPES)
    code = fn(
        pair_data.data_ptr(), pair_data.shape[1], starts.data_ptr(), counts.data_ptr(),
        None if order is None else order.data_ptr(), t, config.tiles_x, config.tile_size,
        0 if on_device else row_offset, row_offset.data_ptr() if on_device else None,
        2.0 / config.screen_w, 2.0 / config.screen_h,
        config.raster_chunk, config.transmittance_eps,
        int(config.falloff == "gaussian"), int(config.background is not None),
        *geometry, out.data_ptr(), None if blended is None else blended.data_ptr(),
        cb.stream_handle(pair_data),
    )
    cb.check("raster", code)
    rasterize_tiles.launches += 1
    return out


rasterize_tiles.launches = 0
# gsr_raster's parameters, as csrc/raster.cu declares them.
RASTER_ARGTYPES = [cb.P, cb.I64, cb.P, cb.P, cb.P, cb.I32, cb.I32, cb.I32, cb.I32, cb.P, cb.F32,
                   cb.F32, cb.I32, cb.F32, cb.I32, cb.I32, cb.I32, cb.I32, cb.I32, cb.I32, cb.P,
                   cb.P, cb.P]


def tiles_to_image(tile_rgba: torch.Tensor, config: RenderConfig) -> torch.Tensor:
    """[T, pixels, 4] tile-major float -> [height, width, 4] uint8.

    Quantization matches the reference: truncating *255 cast, alpha 255 on
    covered tiles, untouched tiles stay fully zero (cu:1007-1015 plus the
    frame-start clear at Demo.cpp:399).
    """
    tx = config.tiles_x
    ts = config.tile_size
    rows = tile_rgba.shape[0] // tx  # < tiles_y when rendering a band
    img = tile_rgba.reshape(rows, tx, ts, ts, 4)
    img = img.permute(0, 2, 1, 3, 4).reshape(rows * ts, tx * ts, 4)
    rgb = img[..., :3]
    alpha = img[..., 3:4]
    if config.background is not None:
        # Channel 3 carries per-pixel transmittance in this mode.  The
        # colour's three floats enter as scalars, so no host-to-device copy
        # sits in the frame.
        rgb = rgb + torch.stack([alpha[..., 0] * c for c in config.background], dim=-1)
        alpha = torch.ones_like(alpha)
    if config.gamma is not None:
        rgb = torch.pow(torch.clamp(rgb, 0.0, 1.0), config.gamma)
    rgba = torch.cat([rgb, alpha], dim=-1)
    return (torch.clamp(rgba, 0.0, 1.0) * 255.0).to(torch.uint8)
