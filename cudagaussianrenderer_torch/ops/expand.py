"""Tile-list emission — kernels K2 (interleave), K3 (emit) and K8 (banded
emit) of stage C.

Slot j of the fixed-capacity pair list belongs to the splat whose
[excl_i, incl_i) candidate-count prefix segment contains j; the slot gets
that splat's sort key (tile, depth), its index, and the three packed
raster attribute words.

The JAX package (ops/expand.py there) gives each grid step a block of
slots and selects every slot's owner with one-hot matmuls over DMA'd splat
windows, fed by a table of per-block first owners.  The port's kernel
(csrc/emit.cu) is slot-parallel too, one thread block per emit block of
slots, but finds its first owner itself with a cooperative search of the
prefix row, stages the owners' rows once in shared memory and lets every
thread write its own slot.  The kernels here:

  * K2 ``interleave_rows`` (csrc/interleave.cu) builds the [16, NP] f32
    row array the JAX package's ``_interleave_rows`` builds (clamped
    exclusive/inclusive prefix rows, the splat-id row, 13 attribute rows,
    one zero-filled PREP_BLK block whose prefix rows continue at the
    clamped total), bit for bit.
  * K3 ``emit_slots`` (csrc/emit.cu) reads those rows and writes the six
    [capacity] words, equal slot for slot to the JAX ``_emit_kernel``.
  * K8 ``emit_slots_banded`` (the banded mode of csrc/emit.cu) does the
    same over the band-compacted rows of ops.banded.compact_rows, with the
    slots segmented into G bands, equal slot for slot to the JAX
    ``_emit_kernel`` with ``bpb > 0``.

Each has a plain PyTorch version beside it (``_interleave_rows_torch``,
``_emit_torch``, flat and banded) that the wrapper runs for CPU tensors;
on a CUDA tensor the wrapper launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..utils import cuda_build as cb
from .geometry import as_i32, pack_center_u32, pack_conic_u32, pack_rgba_u32

# Slots per emit block of the JAX kernel: 1024, halved while it does not
# divide the capacity (down to 128).  Slots past the candidate total in a
# block that still holds pairs carry the packing of an all-zero row; whole
# blocks past it carry zeros.  Both packages reproduce that layout.
MAX_BLOCK = 1024
MIN_BLOCK = 128

# f32 represents integers exactly only below 2^24; prefix sums clamped to
# capacity + 1, packed tile rects, packed rgb and splat ids travel as f32.
MAX_EXACT_I32 = 1 << 24
# The largest pair-list capacity, with headroom — the single source of
# truth for every host capacity clamp (render.Renderer).
MAX_CAPACITY = MAX_EXACT_I32 - (1 << 18)

# Row layout of the [16, NP] rows array after the two prefix rows.
R_GEOM, R_DEPTH, R_IDX = 0, 1, 2
R_CX, R_CY = 3, 4
R_CA, R_CB, R_CC, R_RGB, R_ALPHA = 5, 6, 7, 8, 9
R_PACK0 = 10  # .. R_PACK0+3: per-row (dx, w) 6-bit fields, 2 rows each
NUM_ROWS_IN = 14

# Output order (six flat [C] words, int32 bit patterns).
OUT_KEY0, OUT_KEY1, OUT_VALUES = 0, 1, 2
OUT_CXCY, OUT_CONIC, OUT_RGBA = 3, 4, 5
NUM_OUT = 6

DEPTH_SHIFT = 19
SENTINEL_KEY = 0xFFFFFFFF

# Column block of the rows array: the splat axis is padded to a multiple
# of PREP_BLK, and one more PREP_BLK block of zero fill follows.
PREP_BLK = 4096


def emit_block(capacity: int) -> int:
    """Slots per emit block for ``capacity`` (see MAX_BLOCK)."""
    block = MAX_BLOCK
    while block > MIN_BLOCK and capacity % block:
        block //= 2
    if capacity % block != 0:
        raise ValueError(f"capacity must be a multiple of {block}")
    return block


def rows_width(n: int) -> int:
    """NP: columns of the rows array for ``n`` splats."""
    return -(-n // PREP_BLK) * PREP_BLK + PREP_BLK


# ---------------------------------------------------------------------------
# K2: interleave
# ---------------------------------------------------------------------------

def _interleave_rows_torch(incl: torch.Tensor, cols, clamp: int) -> torch.Tensor:
    """Plain PyTorch version of K2 (see interleave_rows)."""
    n = incl.shape[0]
    np_cols = rows_width(n)
    n_live = np_cols - PREP_BLK
    out = torch.zeros((2 + NUM_ROWS_IN, np_cols), dtype=torch.float32, device=incl.device)
    # Padded splats repeat the final prefix value: zero counts.
    incl_p = torch.cat([incl, incl[-1:].expand(n_live - n)])
    excl_p = torch.cat([torch.zeros_like(incl[:1]), incl_p[:-1]])
    out[0, :n_live] = torch.clamp(excl_p, max=clamp).to(torch.float32)
    out[1, :n_live] = torch.clamp(incl_p, max=clamp).to(torch.float32)
    out[0:2, n_live:] = torch.clamp(incl[-1], max=clamp).to(torch.float32)
    k = 0
    for r in range(NUM_ROWS_IN):
        if r == R_IDX:
            out[2 + r, :n_live] = torch.arange(n_live, device=incl.device).to(torch.float32)
        else:
            out[2 + r, :n] = cols[k]
            k += 1
    return out


def interleave_rows(incl: torch.Tensor, cols, clamp: int) -> torch.Tensor:
    """K2: the [16, NP] f32 rows array of ``n`` splats.

    incl: [n] int32 inclusive candidate prefix sum.  cols: 13 contiguous
    [n] float32 columns in R_* order without R_IDX.  Columns c < n_live
    (n rounded up to PREP_BLK) hold min(excl, clamp), min(incl, clamp),
    then the 14 attribute rows with R_IDX = c (padding columns repeat the
    final prefix and carry zero attributes); the last PREP_BLK columns
    hold min(incl[-1], clamp) in both prefix rows and zeros elsewhere.
    Replaces ops/expand.py:_interleave_rows of the JAX package.
    """
    if len(cols) != NUM_ROWS_IN - 1:
        raise ValueError(f"expected {NUM_ROWS_IN - 1} columns, got {len(cols)}")
    if cb.dispatch_device(incl) == "cpu":
        return _interleave_rows_torch(incl, cols, clamp)
    n = incl.shape[0]
    dev = incl.device
    cb.require(incl, "incl", torch.int32, dev, (n,))
    for i, c in enumerate(cols):
        cb.require(c, f"cols[{i}]", torch.float32, dev, (n,))
    np_cols = rows_width(n)
    out = torch.empty((2 + NUM_ROWS_IN, np_cols), dtype=torch.float32, device=dev)
    fn = cb.kernel(
        "interleave", "gsr_interleave",
        [cb.P, cb.P, cb.I64, cb.I64, cb.I32, cb.P, cb.P],
    )
    ptrs = (cb.P * len(cols))(*[c.data_ptr() for c in cols])
    code = fn(incl.data_ptr(), ptrs, n, np_cols, clamp, out.data_ptr(), cb.stream_handle(incl))
    cb.check("interleave", code)
    interleave_rows.launches += 1
    return out


interleave_rows.launches = 0


# ---------------------------------------------------------------------------
# K3: emit
# ---------------------------------------------------------------------------

def _emit_torch(rows: torch.Tensor, capacity: int, config: RenderConfig, *, block=None,
                pair_end=None, band_rows=None):
    """Plain PyTorch version of K3 (see emit_slots) and, with ``pair_end``
    and ``band_rows``, of K8 (see emit_slots_banded): one lane per SLOT,
    each finding its owner by binary search over the inclusive prefix
    row, the decomposition of both the JAX kernel and the CUDA one."""
    dev = rows.device
    np_cols = rows.shape[1]
    banded = pair_end is not None
    if block is None:
        block = emit_block(capacity)
    incl = rows[1].to(torch.int64)
    excl = rows[0].to(torch.int64)
    j = torch.arange(capacity, device=dev, dtype=torch.int64)
    if banded:
        # Each slot's band ends at that band's pair end; the compacted
        # inclusive row is monotone across bands, so the search still holds.
        band = j // (capacity // pair_end.shape[0])
        total = torch.clamp(pair_end.to(torch.int64), max=capacity)[band]
        band_lo = band_rows.to(torch.int64)[band]
        band_hi = band_rows.to(torch.int64)[band + 1]
    else:
        total = torch.clamp(incl[-1], max=capacity)
    valid = j < total
    owner = torch.clamp(torch.searchsorted(incl, j, right=True), max=np_cols - 1)
    # Slots past the total in a block that holds pairs see all-zero rows
    # (the JAX kernel's empty selection); later blocks are all zeros.
    live_end = torch.clamp((total + block - 1) // block * block, max=capacity)
    g = torch.where(valid[None, :], rows[:, owner], 0.0)

    def irow(r):
        return g[2 + r].to(torch.int64)

    o = j - torch.where(valid, excl[owner], 0)
    geom = irow(R_GEOM)
    w_raw = geom & 255
    y0 = (geom >> 8) & 255
    x0 = geom >> 16
    cum = torch.zeros_like(o)
    sel_cum = torch.zeros_like(o)
    sel_dx = torch.zeros_like(o)
    sel_ly = torch.zeros_like(o)
    for r in range(8):
        p = irow(R_PACK0 + r // 2)
        half = (p >> 12) if r % 2 == 0 else (p & 4095)
        dx_r = half >> 6
        w_r = half & 63
        if banded:
            # Only runs on the band's own tile rows count.
            w_r = torch.where((y0 + r >= band_lo) & (y0 + r < band_hi), w_r, 0)
        nxt = cum + w_r
        m = (cum <= o) & (o < nxt)
        sel_cum = torch.where(m, cum, sel_cum)
        sel_dx = torch.where(m, dx_r, sel_dx)
        sel_ly = torch.where(m, r, sel_ly)
        cum = nxt
    in_packed = o < cum
    extra = torch.clamp(o - cum, min=0)
    w_f = torch.clamp(w_raw, min=1)
    ly_rel = extra // w_f
    lx_o = extra - ly_rel * w_f
    base_row = torch.where(w_raw > 63, 0, 8)
    if banded:
        # Full-width rows start at the band's first row.
        base_row = torch.maximum(base_row, band_lo - y0)
    gy = y0 + torch.where(in_packed, sel_ly, base_row + ly_rel)
    gx = x0 + torch.where(in_packed, sel_dx + (o - sel_cum), lx_o)
    tile = gy * config.tiles_x + gx
    q = irow(R_DEPTH)
    if config.depth_bits == DEPTH_SHIFT:
        key0 = torch.where(valid, (tile << DEPTH_SHIFT) | q, SENTINEL_KEY)
        key1 = torch.zeros_like(key0)
    else:
        key0 = torch.where(valid, tile, config.sentinel_tile)
        key1 = torch.where(valid, q << 8, SENTINEL_KEY)
    values = torch.where(valid, irow(R_IDX), -1)

    zero = torch.zeros_like(key0, dtype=torch.int32)
    in_block = j < live_end
    cxcy = torch.where(in_block, pack_center_u32(g[2 + R_CX], g[2 + R_CY]), zero)
    conic = torch.where(
        in_block, pack_conic_u32(g[2 + R_CA], g[2 + R_CB], g[2 + R_CC]), zero
    )
    rgba = torch.where(in_block, pack_rgba_u32(irow(R_RGB), g[2 + R_ALPHA]), zero)
    return (as_i32(key0), as_i32(key1), values.to(torch.int32), cxcy, conic, rgba)


def emit_slots(rows: torch.Tensor, capacity: int, config: RenderConfig):
    """K3: the six [capacity] int32 words of the pair list, from K2's rows.

    For each slot j < min(total, capacity), owned by splat i
    (excl_i <= j < incl_i, ordinal o = j - excl_i): the tile of ordinal o
    in the splat's 8 packed (dx, w) row runs, or past them in the
    full-rect fallthrough rows; key tile<<19 | depth19 (or tile, depth<<8
    when depth_bits = 32); value i; packed cxcy, conic and rgba.  Slots
    past the total get sentinel keys, value -1, and the attribute fill of
    the JAX kernel's block layout (see MAX_BLOCK).
    Replaces ops/expand.py:_emit_kernel (with _emit_block, _emit_payload
    and _store_sentinels) of the JAX package.
    """
    if capacity + 1 >= MAX_EXACT_I32:
        raise ValueError("capacity too large for exact f32 prefix rows")
    if cb.dispatch_device(rows) == "cpu":
        return _emit_torch(rows, capacity, config)
    dev = rows.device
    np_cols = rows.shape[1]
    cb.require(rows, "rows", torch.float32, dev, (2 + NUM_ROWS_IN, np_cols))
    block = emit_block(capacity)
    outs = [torch.empty(capacity, dtype=torch.int32, device=dev) for _ in range(NUM_OUT)]
    fn = cb.kernel(
        "emit", "gsr_emit",
        [cb.P, cb.I64, cb.I32, cb.I32, cb.I32, cb.I32, cb.I32] + [cb.P] * NUM_OUT + [cb.P],
    )
    code = fn(
        rows.data_ptr(), np_cols, capacity, block,
        int(config.depth_bits == DEPTH_SHIFT), config.tiles_x, config.sentinel_tile,
        *[o.data_ptr() for o in outs], cb.stream_handle(rows),
    )
    cb.check("emit", code)
    emit_slots.launches += 1
    return tuple(outs)


emit_slots.launches = 0


def emit_slots_banded(
    rows: torch.Tensor,
    capacity: int,
    config: RenderConfig,
    pair_end: torch.Tensor,
    band_rows: torch.Tensor,
    block: int,
):
    """K8: the six [capacity] int32 words of a band-segmented pair list,
    from the band-compacted rows of ops.banded.compact_rows.

    rows: [16, G * MC] f32; column c belongs to band c // MC and its prefix
    rows hold band-offset pair prefixes inside [g * CG, (g + 1) * CG),
    CG = capacity / G.  pair_end: [G] int32, the slot where band g's pairs
    end; band_rows: [G + 1] int32 tile-row boundaries.  Slots below a
    band's pair end are filled as emit_slots fills them, except that a
    splat's ordinals count only tiles on the band's rows: packed runs of
    rows outside [lo_g, hi_g) are skipped and the full-rect fallthrough
    starts at max(base_row, lo_g - y0), mirroring ops.banded.band_counts.
    From the pair end to the end of the segment: sentinel keys, value -1,
    and the attribute fill of the JAX kernel's block layout per band
    (``block`` slots per block, dividing CG; see ops.banded.banded_block).
    Replaces the banded mode (bpb > 0) of ops/expand.py:_emit_kernel of
    the JAX package.
    """
    if capacity + 1 >= MAX_EXACT_I32:
        raise ValueError("capacity too large for exact f32 prefix rows")
    n_bands = pair_end.shape[0]
    cg = capacity // n_bands
    mc = rows.shape[1] // n_bands
    if cg * n_bands != capacity or cg % block or mc * n_bands != rows.shape[1]:
        raise ValueError(
            f"capacity {capacity} and {rows.shape[1]} compact columns must split "
            f"into {n_bands} bands of whole {block}-slot blocks"
        )
    if band_rows.shape != (n_bands + 1,):
        raise ValueError(f"band_rows must have {n_bands + 1} entries, got {tuple(band_rows.shape)}")
    if cb.dispatch_device(rows) == "cpu":
        return _emit_torch(rows, capacity, config, block=block, pair_end=pair_end,
                           band_rows=band_rows)
    dev = rows.device
    cb.require(rows, "rows", torch.float32, dev, (2 + NUM_ROWS_IN, n_bands * mc))
    cb.require(pair_end, "pair_end", torch.int32, dev, (n_bands,))
    cb.require(band_rows, "band_rows", torch.int32, dev, (n_bands + 1,))
    outs = [torch.empty(capacity, dtype=torch.int32, device=dev) for _ in range(NUM_OUT)]
    fn = cb.kernel(
        "emit", "gsr_emit_banded",
        [cb.P, cb.I32, cb.I64, cb.I32, cb.I32, cb.I32, cb.I32, cb.I32, cb.P, cb.P]
        + [cb.P] * NUM_OUT + [cb.P],
    )
    code = fn(
        rows.data_ptr(), n_bands, mc, cg, block,
        int(config.depth_bits == DEPTH_SHIFT), config.tiles_x, config.sentinel_tile,
        pair_end.data_ptr(), band_rows.data_ptr(),
        *[o.data_ptr() for o in outs], cb.stream_handle(rows),
    )
    cb.check("emit", code)
    emit_slots_banded.launches += 1
    return tuple(outs)


emit_slots_banded.launches = 0


def emit_pairs(cols, incl: torch.Tensor, capacity: int, config: RenderConfig):
    """Expand + pack the pair list: K2 then K3.

    cols: 13 flat [N] per-splat columns in R_* order with R_IDX omitted;
    integers pre-cast to f32, all < 2^24.  incl: [N] int32 inclusive
    prefix sum of candidate counts.  Returns six flat [capacity] int32
    words in OUT_* order.

    Unlike the JAX package, the port builds no table of per-block first
    owners (the JAX package's second use of its histogram kernel,
    ops/expand.py:711-717 there): each block of K3 searches the prefix row
    for its own.
    """
    emit_block(capacity)
    cols = tuple(c.to(torch.float32).contiguous() for c in cols)
    rows = interleave_rows(incl.to(torch.int32).contiguous(), cols, capacity + 1)
    return emit_slots(rows, capacity, config)
