"""Band-segmented pair emission — everything behind ``config.sort_bands > 1``.

The pair list is segmented into G equal-capacity tile-row bands: band g's
segment holds exactly that band's (splat, tile) pairs, so stage D sorts
each segment on its own (sort_pairs_banded) and the concatenation is
globally tile-ordered, because bands partition the tile rows in order.
Per-band sentinel runs sit BETWEEN bands and are skipped through the
band-offset range starts of ops.ranges.tile_ranges.

Stage C of the banded frame, as in the JAX package (ops/banded.py there):

  band_counts          per-band candidate counts [G, N]            (torch)
  band_prefixes        per-band pair and compact-slot prefixes     (torch)
  K5 interleave_rows_padded   15 columns -> [16, NP] source rows   (csrc/interleave.cu)
  K6 stack_rows               3 prefix columns -> [3, G * NP]      (csrc/stack.cu)
  K7 compact_rows             band compaction -> [16, G * MC]      (csrc/compact.cu)
  K8 expand.emit_slots_banded the six [capacity] words             (csrc/emit.cu)

The JAX package needs the compaction because a TPU cannot scatter: its
emit walk must be dense over the splat axis, so it first gathers each
band's splats together with a one-hot matmul.  The port keeps the two
passes and their intermediate arrays — the tests hold each against the
JAX package — but both kernels scatter: a source column's values go to its
own compact slot, and a compact column's to its own pair slots.

Each kernel has its plain PyTorch version beside it, which the wrapper
runs for CPU tensors only; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import RenderConfig
from ..utils import cuda_build as cb
from .binning import (
    DEPTH_BITS_PACKED,
    MAX_PACK_W,
    RowPacks,
    TilePairs,
    TileRects,
    pack_columns,
    splat_row_packs,
    splat_tile_rects,
)
from .expand import (
    MAX_BLOCK,
    MAX_EXACT_I32,
    MIN_BLOCK,
    NUM_ROWS_IN,
    OUT_CONIC,
    OUT_CXCY,
    OUT_KEY0,
    OUT_KEY1,
    OUT_RGBA,
    OUT_VALUES,
    PREP_BLK,
    R_IDX,
    emit_slots_banded,
)
from .geometry import as_i32, as_u32_i64
from .projection import SplatClipData

# Splats per DMA window of the JAX kernels.  The port walks no windows; the
# constant survives only in the width of the source rows array, which both
# packages pad alike so that the arrays compare bit for bit.
WINDOW = 512
# Most columns one stack_rows call takes (kMaxStack of csrc/stack.cu).
MAX_STACK = 8


def padded_width(n: int) -> int:
    """NP: columns of the banded source rows array for ``n`` splats."""
    return -(-(n + 2 * WINDOW + 128) // PREP_BLK) * PREP_BLK


def banded_block(capacity: int, compact_capacity: int, n_bands: int) -> int:
    """Slots per emit block of a banded list: MAX_BLOCK, halved while it
    does not divide the per-band pair capacity or the per-band compact
    capacity, no lower than MIN_BLOCK."""
    block = MAX_BLOCK
    mc = compact_capacity // n_bands
    while block > MIN_BLOCK and ((capacity // n_bands) % block or mc % block):
        block //= 2
    return block


# ---------------------------------------------------------------------------
# Per-band candidate counts
# ---------------------------------------------------------------------------

def band_counts(rects: TileRects, row_packs: RowPacks, band_rows: torch.Tensor) -> torch.Tensor:
    """[G, N] int32 per-band in-band candidate counts.

    ``band_rows``: [G + 1] int tile-row boundaries; band g covers tile
    rows [band_rows[g], band_rows[g + 1]).  Mirrors the banded emit
    kernel's slot mapping: packed rows count only inside the band, and
    full-width fallthrough rows run from max(base, lo - y0) to
    min(h, hi - y0), where base is 8 for packable rects and 0 for
    w > MAX_PACK_W ones.  Summing over a full partition of the rows
    reproduces row_packs.counts exactly.

    All arithmetic is on exact small integers in f32.  The eight packed
    row widths become one running sum [9, N]; a band's packed count is the
    difference of that sum at the band's two row bounds (clamped into the
    eight rows), one gather each for all G bands at once.
    """
    y0f = rects.y0.to(torch.float32)
    hf = rects.h.to(torch.float32)
    wf = rects.w.to(torch.float32)
    base_flat = torch.where(rects.w <= MAX_PACK_W, 8.0, 0.0)

    # Per-row widths from the packed (dx, w) fields; zero for unpackable
    # splats and dead rows by construction (splat_row_packs).
    cum = [torch.zeros_like(y0f)]
    for p in range(4):
        t = row_packs.packs[p]
        t_hi = torch.floor(t * (1.0 / 4096.0))
        t_lo = t - t_hi * 4096.0
        for half in (t_hi, t_lo):
            cum.append(cum[-1] + (half - torch.floor(half * (1.0 / 64.0)) * 64.0))
    cum = torch.stack(cum)                                        # [9, N]

    lo = band_rows[:-1].to(torch.float32)[:, None]                # [G, 1]
    hi = band_rows[1:].to(torch.float32)[:, None]
    lo_rel = lo - y0f                                             # [G, N]
    hi_rel = hi - y0f
    r_lo = torch.clamp(lo_rel, 0.0, 8.0).to(torch.int64)
    r_hi = torch.clamp(hi_rel, 0.0, 8.0).to(torch.int64)
    packed_sum = torch.clamp(cum.gather(0, r_hi) - cum.gather(0, r_lo), min=0.0)
    over = wf * torch.clamp(
        torch.minimum(hf, hi_rel) - torch.maximum(base_flat, lo_rel), min=0.0
    )
    return (packed_sum + over).to(torch.int32)


# ---------------------------------------------------------------------------
# K5: the source rows array
# ---------------------------------------------------------------------------

def _interleave_rows_padded_torch(prefix_and_cols, np_cols: int) -> torch.Tensor:
    """Plain PyTorch version of K5 (see interleave_rows_padded)."""
    dev = prefix_and_cols[0].device
    n = prefix_and_cols[0].shape[0]
    out = torch.zeros((2 + NUM_ROWS_IN, np_cols), dtype=torch.float32, device=dev)
    k = 0
    for r in range(2 + NUM_ROWS_IN):
        if r == 2 + R_IDX:
            out[r] = torch.arange(np_cols, device=dev).to(torch.float32)
        else:
            out[r, :n] = prefix_and_cols[k]
            k += 1
    return out


def interleave_rows_padded(prefix_and_cols, np_cols: int) -> torch.Tensor:
    """K5: 15 flat f32 columns -> the [16, np_cols] source rows array.

    prefix_and_cols: the two prefix rows (supplied by the caller) and the
    13 attribute columns in R_* order without R_IDX, each a contiguous [n]
    float32 tensor, n <= np_cols.  Row r of the result is column r padded
    with zeros to np_cols, except row 2 + R_IDX, which is the column index
    over all np_cols columns.  (The JAX caller pads every column to
    np_cols before its kernel; here the kernel writes the zeros itself.)
    Replaces ops/banded.py:_interleave_rows_padded of the JAX package.
    """
    if len(prefix_and_cols) != 1 + NUM_ROWS_IN:
        raise ValueError(f"expected {1 + NUM_ROWS_IN} columns, got {len(prefix_and_cols)}")
    n = prefix_and_cols[0].shape[0]
    if n > np_cols:
        raise ValueError(f"{n} columns do not fit into np_cols = {np_cols}")
    if cb.dispatch_device(prefix_and_cols[0]) == "cpu":
        return _interleave_rows_padded_torch(prefix_and_cols, np_cols)
    dev = prefix_and_cols[0].device
    for i, c in enumerate(prefix_and_cols):
        cb.require(c, f"prefix_and_cols[{i}]", torch.float32, dev, (n,))
    out = torch.empty((2 + NUM_ROWS_IN, np_cols), dtype=torch.float32, device=dev)
    fn = cb.kernel("interleave", "gsr_interleave_padded", [cb.P, cb.I64, cb.I64, cb.P, cb.P])
    ptrs = (cb.P * len(prefix_and_cols))(*[c.data_ptr() for c in prefix_and_cols])
    code = fn(ptrs, n, np_cols, out.data_ptr(), cb.stream_handle(out))
    cb.check("interleave", code)
    interleave_rows_padded.launches += 1
    return out


interleave_rows_padded.launches = 0


# ---------------------------------------------------------------------------
# K6: stack
# ---------------------------------------------------------------------------

def _stack_rows_torch(cols) -> torch.Tensor:
    """Plain PyTorch version of K6 (see stack_rows)."""
    out = torch.empty((len(cols), cols[0].shape[0]), dtype=torch.float32, device=cols[0].device)
    for r, c in enumerate(cols):
        out[r] = c
    return out


def stack_rows(cols) -> torch.Tensor:
    """K6: k flat contiguous [M] float32 columns -> one [k, M] row array
    (1 <= k <= MAX_STACK).
    Replaces ops/banded.py:_stackk_kernel / _stackk of the JAX package."""
    k = len(cols)
    if not 1 <= k <= MAX_STACK:
        raise ValueError(f"stack_rows takes 1 to {MAX_STACK} columns, got {k}")
    if cb.dispatch_device(cols[0]) == "cpu":
        return _stack_rows_torch(cols)
    dev = cols[0].device
    m = cols[0].shape[0]
    for i, c in enumerate(cols):
        cb.require(c, f"cols[{i}]", torch.float32, dev, (m,))
    out = torch.empty((k, m), dtype=torch.float32, device=dev)
    fn = cb.kernel("stack", "gsr_stack", [cb.P, cb.I32, cb.I64, cb.P, cb.P])
    ptrs = (cb.P * k)(*[c.data_ptr() for c in cols])
    code = fn(ptrs, k, m, out.data_ptr(), cb.stream_handle(out))
    cb.check("stack", code)
    stack_rows.launches += 1
    return out


stack_rows.launches = 0


# ---------------------------------------------------------------------------
# K7: band compaction
# ---------------------------------------------------------------------------

def _compact_rows_torch(
    full: torch.Tensor, pfx: torch.Tensor, pair_end: torch.Tensor, compact_capacity: int
) -> torch.Tensor:
    """Plain PyTorch version of K7 (see compact_rows)."""
    dev = full.device
    n_bands = pair_end.shape[0]
    np_cols = full.shape[1]
    mc = compact_capacity // n_bands
    slot_band = torch.clamp(torch.arange(compact_capacity, device=dev) // mc, max=n_bands - 1)
    out = torch.zeros((2 + NUM_ROWS_IN, compact_capacity), dtype=torch.float32, device=dev)
    out[0:2] = pair_end.to(torch.float32)[slot_band]
    writes = torch.nonzero(pfx[1] != pfx[2])[:, 0]
    slot = pfx[0, writes].to(torch.int64) - 1
    out[0:2, slot] = pfx[1:3, writes]
    out[2:, slot] = full[2:, writes % np_cols]
    return out


def compact_rows(
    full: torch.Tensor, pfx: torch.Tensor, pair_end: torch.Tensor, compact_capacity: int
) -> torch.Tensor:
    """K7: band compaction of the source rows -> [16, compact_capacity] f32.

    full: [16, NP] source rows (K5; rows 0-1 unused).  pfx: [3, G * NP]
    (K6), band g in columns [g * NP, (g + 1) * NP): row 0 c_incl (the
    band-offset clamped compact-slot cumsum), row 1 p_excl and row 2
    p_incl (band-offset clamped pair prefixes).  The JAX package carries a
    fourth row, p_incl again, only to fill its DMA tile of 4 rows; nothing
    reads it, so the port stacks three.  pair_end: [G] int32.
    With MC = compact_capacity / G: a column of band g with
    p_excl != p_incl — a kept splat — owns slot c_incl - 1, which gets
    (p_excl, p_incl) in rows 0-1 and the splat's 14 attribute rows below;
    every other slot of band g = min(slot // MC, G - 1) gets the band's
    pair end in rows 0-1 and zeros below.  The kernel takes the prefixes as
    band_prefixes and band_prefix_columns make them: up to a band's last
    kept column c_incl rises by one at every kept column and nowhere else,
    so the kept columns own the first c_incl[g, -1] - g * MC slots of the
    band in source order, and the fill the rest.

    The JAX array carries a trailing slack of a few blocks past
    compact_capacity so that its DMA windows can overrun; nothing walks
    windows here, so the port's array ends at compact_capacity and equals
    the JAX array's first compact_capacity columns.
    Replaces ops/banded.py:_compact_kernel of the JAX package.
    """
    n_bands = pair_end.shape[0]
    np_cols = full.shape[1]
    mc = compact_capacity // n_bands
    if mc * n_bands != compact_capacity or mc < 1:
        raise ValueError(f"compact_capacity {compact_capacity} does not split into {n_bands} bands")
    if compact_capacity + 1 >= MAX_EXACT_I32:
        raise ValueError("compact_capacity too large for exact f32 prefix rows")
    if cb.dispatch_device(full) == "cpu":
        return _compact_rows_torch(full, pfx, pair_end, compact_capacity)
    dev = full.device
    cb.require(full, "full", torch.float32, dev, (2 + NUM_ROWS_IN, np_cols))
    cb.require(pfx, "pfx", torch.float32, dev, (3, n_bands * np_cols))
    cb.require(pair_end, "pair_end", torch.int32, dev, (n_bands,))
    out = torch.empty((2 + NUM_ROWS_IN, compact_capacity), dtype=torch.float32, device=dev)
    fn = cb.kernel(
        "compact", "gsr_compact", [cb.P, cb.P, cb.P, cb.I64, cb.I32, cb.I64, cb.P, cb.P]
    )
    code = fn(full.data_ptr(), pfx.data_ptr(), pair_end.data_ptr(), np_cols, n_bands, mc,
              out.data_ptr(), cb.stream_handle(full))
    cb.check("compact", code)
    compact_rows.launches += 1
    return out


compact_rows.launches = 0


# ---------------------------------------------------------------------------
# Per-band prefixes and the two-pass emission
# ---------------------------------------------------------------------------

class BandPrefixes(NamedTuple):
    """Per-band prefixes of one frame (all int32, values < 2^24)."""

    c_incl: torch.Tensor       # [G, N] band-offset clamped compact-slot cumsum
    p_excl: torch.Tensor       # [G, N] band-offset clamped exclusive pair prefix
    p_incl: torch.Tensor       # [G, N] band-offset clamped inclusive pair prefix
    pair_end: torch.Tensor     # [G] slot where the band's reachable pairs end
    band_totals: torch.Tensor  # [G] unclamped per-band candidate counts
    band_splats: torch.Tensor  # [G] unclamped per-band in-band splat counts


def _row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 cumsum along dim 1 of a [G, N] tensor.

    One scan of the flattened tensor minus each row's offset, because
    PyTorch's scan along the last dimension of a few very long rows uses
    little of the card.  Exact whenever each row's own sums fit int32
    (int32 arithmetic wraps, so a wrapped flat sum still yields the row's
    sum after the subtraction).
    """
    flat = torch.cumsum(x.reshape(-1), 0, dtype=torch.int32).view(x.shape)
    offsets = torch.cat([torch.zeros_like(flat[:1, -1]), flat[:-1, -1]])
    return flat - offsets[:, None]


def band_prefixes(counts_banded: torch.Tensor, cg: int, mc: int) -> BandPrefixes:
    """The prefix math of the banded emission, in plain torch cumsums.

    counts_banded: [G, N] int32 (band_counts).  cg, mc: per-band pair and
    compact-slot capacities.

    A splat is selected into a band only if at least one of its pairs
    lands below the band's pair capacity; pair-dry splats (their whole
    range clamped past cg) are left out of the compaction like
    compact-saturated ones.  Splats beyond the band's compact capacity
    share the clamped c_incl of the last slot; they get equal pair
    prefixes, which is what keeps them from writing (their pairs are not
    emitted this frame).  The pair end is the last kept splat's clamped
    p_incl: kept splats' pair ranges tile [g * cg, pair_end) without gaps,
    because pair-live splats form a prefix of the band's candidates and
    compact saturation drops a suffix.
    """
    n_bands = counts_banded.shape[0]
    dev = counts_banded.device
    p_cum = _row_cumsum(counts_banded)
    sel = (counts_banded > 0) & (p_cum - counts_banded < cg)
    c_cum = _row_cumsum(sel)
    offs_c = (torch.arange(n_bands, dtype=torch.int32, device=dev) * mc)[:, None]
    offs_p = (torch.arange(n_bands, dtype=torch.int32, device=dev) * cg)[:, None]
    c_incl = offs_c + torch.clamp(c_cum, max=mc)
    p_incl = offs_p + torch.clamp(p_cum, max=cg)
    kept = sel & (c_cum <= mc)
    p_excl = torch.where(kept, offs_p + torch.clamp(p_cum - counts_banded, max=cg), p_incl)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    pair_end = offs_p[:, 0] + torch.clamp(torch.where(kept, p_cum, zero).amax(1), max=cg)
    return BandPrefixes(
        c_incl=c_incl, p_excl=p_excl, p_incl=p_incl, pair_end=pair_end,
        band_totals=p_cum[:, -1], band_splats=c_cum[:, -1],
    )


def band_prefix_columns(pre: BandPrefixes, np_cols: int):
    """The three flat [G * np_cols] f32 columns that K6 stacks into the
    prefix rows of K7: c_incl, p_excl and p_incl, each band padded from N
    to np_cols columns.  c_incl pads with its edge (monotone), the pair
    rows with the band's final p_incl, so pad columns have excl == incl
    and own nothing."""
    n_bands, n = pre.p_incl.shape

    def pad_band(x, tail):
        fill = tail.to(torch.float32).expand(n_bands, np_cols - n)
        return torch.cat([x.to(torch.float32), fill], 1).reshape(n_bands * np_cols)

    return (
        pad_band(pre.c_incl, pre.c_incl[:, -1:]),
        pad_band(pre.p_excl, pre.p_incl[:, -1:]),
        pad_band(pre.p_incl, pre.p_incl[:, -1:]),
    )


def emit_pairs_banded(
    cols,
    counts_banded: torch.Tensor,
    band_rows: torch.Tensor,
    capacity: int,
    config: RenderConfig,
    *,
    compact_capacity: int = 0,
):
    """Band-major expand + pack in two passes: K5/K6/K7, then K8.

    cols: 13 flat [N] f32 columns as in expand.emit_pairs.
    counts_banded: [G, N] int32 (band_counts).  band_rows: [G + 1] int32
    tile-row boundaries.  compact_capacity: total compacted-splat slots (a
    multiple of G * block); 0 -> 2x the splat count.  A band whose in-band
    splat count exceeds its share drops trailing splats' pairs for the
    frame, and a band whose pair count exceeds capacity / G drops its
    trailing pairs (saturation; the returned counts are unclamped).

    Returns (six flat [capacity] int32 words, band_totals [G] int32,
    band_splats [G] int32, pair_end [G] int32 — the slot where each band's
    emitted pairs end).

    The JAX function also computes each band's last in-band splat and two
    tables of per-block first owners (its histogram kernel, twice).  They
    steer its kernels' DMA window walks and nothing else; kernels that
    scatter walk no windows, so the port computes neither.
    """
    n_bands = int(counts_banded.shape[0])
    n = counts_banded.shape[1]
    block = banded_block(capacity, compact_capacity or 2 * n, n_bands)
    cg = capacity // n_bands
    if cg * n_bands != capacity or cg % block != 0:
        raise ValueError(
            f"capacity must be a multiple of bands*{block} (got {capacity}, {n_bands} bands)"
        )
    if capacity + 1 >= MAX_EXACT_I32:
        raise ValueError("capacity too large for exact f32 prefix rows")
    cols = tuple(c.to(torch.float32).contiguous() for c in cols)
    if len(cols) != NUM_ROWS_IN - 1:
        raise ValueError(f"expected {NUM_ROWS_IN - 1} columns, got {len(cols)}")
    if not compact_capacity:
        compact_capacity = -(-2 * n // (n_bands * block)) * (n_bands * block)
    mc = compact_capacity // n_bands
    if mc * n_bands != compact_capacity or mc % block != 0:
        raise ValueError("compact_capacity must be a multiple of bands*block")
    if compact_capacity + 1 >= MAX_EXACT_I32:
        raise ValueError("compact_capacity too large for exact f32 prefix rows")

    pre = band_prefixes(counts_banded, cg, mc)

    # ---- pass-1 inputs: source rows + banded prefix rows ----
    np_cols = padded_width(n)
    zeros = torch.zeros(n, dtype=torch.float32, device=counts_banded.device)
    full = interleave_rows_padded((zeros, zeros) + cols, np_cols)
    pfx = stack_rows(band_prefix_columns(pre, np_cols))

    # ---- pass 1: band compaction; pass 2: emission over the compacted axis ----
    compact = compact_rows(full, pfx, pre.pair_end, compact_capacity)
    outs = emit_slots_banded(
        compact, capacity, config, pre.pair_end, band_rows.to(torch.int32).contiguous(), block
    )
    return outs, pre.band_totals, pre.band_splats, pre.pair_end


def build_tile_pairs_banded(
    clip_data: SplatClipData,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    config: RenderConfig,
    capacity: int,
    band_rows: torch.Tensor,
    *,
    compact_capacity: int = 0,
) -> Tuple[TilePairs, torch.Tensor, torch.Tensor]:
    """Band-major expansion: like binning.build_tile_pairs, but the pair
    list is segmented into G = len(band_rows) - 1 equal-capacity tile-row
    bands, for sort_pairs_banded and the band arguments of
    ranges.tile_ranges.

    Returns (pairs, band_totals [G], band_splats [G]) — unclamped per-band
    pair and in-band splat counts: the saturation signals and the input of
    render.Renderer's equal-count boundary controller.
    """
    rects = splat_tile_rects(clip_data, config)
    row_packs = splat_row_packs(clip_data, rects, config)
    counts_b = band_counts(rects, row_packs, band_rows)
    cols = pack_columns(clip_data, colors, opacities, config, rects, row_packs)

    out, band_totals, band_splats, pair_end = emit_pairs_banded(
        cols, counts_b, band_rows, capacity, config, compact_capacity=compact_capacity
    )

    attrs = (out[OUT_CXCY], out[OUT_CONIC], out[OUT_RGBA])
    if config.depth_bits == DEPTH_BITS_PACKED:
        keys = (out[OUT_KEY0],)
    else:
        keys = (out[OUT_KEY0], out[OUT_KEY1])
    n_bands = band_totals.shape[0]
    band_start = torch.arange(n_bands, dtype=torch.int32, device=pair_end.device) * (
        capacity // n_bands
    )
    pairs = TilePairs(
        keys=keys,
        values=out[OUT_VALUES],
        attrs=attrs,
        num_candidates=band_totals.sum().to(torch.int32),
        # Emission fills exactly each band's slots below its pair end.
        num_pairs=(pair_end - band_start).sum().to(torch.int32),
    )
    return pairs, band_totals, band_splats


# ---------------------------------------------------------------------------
# Stage D: batched per-band sort
# ---------------------------------------------------------------------------

def sort_pairs_banded(
    pairs: TilePairs,
    n_bands: int,
    *,
    with_values: bool = False,
    stable: bool = False,
) -> Tuple[Tuple[torch.Tensor, ...], Optional[torch.Tensor], Tuple[torch.Tensor, ...]]:
    """Batched per-band sort of a band-major pair list
    (build_tile_pairs_banded): one ``torch.sort`` of the int64 key viewed
    [n_bands, capacity / n_bands] along the segment axis, then a per-row
    gather of the values and attribute words.  Each band's sentinels stay
    at the end of its own segment."""
    if len(pairs.keys) == 1:
        key = as_u32_i64(pairs.keys[0])
    else:
        key = (as_u32_i64(pairs.keys[0]) << 32) | as_u32_i64(pairs.keys[1])
    cap = key.shape[0]
    seg = cap // n_bands
    if seg * n_bands != cap:
        raise ValueError(f"a {cap}-slot list does not split into {n_bands} bands")
    sorted_key, perm = torch.sort(key.view(n_bands, seg), dim=1, stable=stable or with_values)
    sorted_key = sorted_key.reshape(cap)
    if len(pairs.keys) == 1:
        keys = (as_i32(sorted_key),)
    else:
        keys = (as_i32(sorted_key >> 32), as_i32(sorted_key & 0xFFFFFFFF))

    def take(word):
        return word.view(n_bands, seg).gather(1, perm).reshape(cap)

    values = take(pairs.values) if with_values else None
    return keys, values, tuple(take(a) for a in pairs.attrs)
