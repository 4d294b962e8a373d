"""The port's CUDA kernels (K1-K8) against their plain PyTorch versions, on
the card.  The kernels have no CPU mode, so every test here needs a CUDA
device and skips without one.

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

import cudagaussianrenderer_torch as pt
from cudagaussianrenderer_torch import telemetry
from cudagaussianrenderer_torch.golden import golden_render, scene_to_numpy
from cudagaussianrenderer_torch.ops import banded, expand, ranges, raster, sorting, splat
from cudagaussianrenderer_torch.ops.binning import (
    TilePairs, emit_columns, pack_columns, splat_row_packs, splat_tile_rects,
)
from cudagaussianrenderer_torch.ops.projection import project_splats
from cudagaussianrenderer_torch.ops.splat import splat_colors
from cudagaussianrenderer_torch.render import _band_rows_tensor, _frame_pairs, camera_tensors

from torch_port_cases import (
    card_failed_sharded_capture_case, card_fit_dp_case, card_graphed_dp_case,
    card_graphed_renderer_case, card_sharded_case, dp_graph_ranks_case, fit_step_pair,
    mesh_frames_case, anisotropic, rendered_views, run_step_pair,
    COMPACT_CASES, COMPACT_CG, EDGE_CORNER_CASES, SPLAT_CASES, column_bits, compact_counts,
    cull_run, edge_corner_keys, splat_case, widen,
)

pytestmark = pytest.mark.cuda

# K4 against its plain version, after tiles_to_image: the same pairs blended
# in the same order; the kernel folds log2(e) into the conic and takes
# ex2.approx where PyTorch takes exp, and fuses multiply-adds.
K4_LSB_BOUND = 4


HUGE_KW = dict(min_scale=0.3, max_scale=1.6, extent=3.0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def bits(t):
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def stage_c_inputs(dev, n, seed, cfg, scene_kw=None, edit=None):
    scene = pt.random_scene(n, seed=seed, device=dev, **(scene_kw or {})).pad_to_multiple(256)
    cam = pt.Camera(aspect=cfg.aspect).framed(scene.bounds_min, scene.bounds_max)
    c = camera_tensors(cam.camera_data(), dev)
    clip = project_splats(scene.means, scene.scales, scene.quats, c, cfg,
                          opacities=scene.opacities)
    if edit is not None:
        fields = {f: getattr(clip, f).clone() for f in clip._fields}
        edit(fields)
        clip = clip._replace(**fields)
    cols, incl = emit_columns(clip, splat_colors(scene, c), scene.opacities, cfg)
    return tuple(x.contiguous() for x in cols), incl


EMIT_CASES = [
    ("default", dict(screen_size=128), 500, 2, None, 4096, None),
    ("truncated-lex", dict(screen_size=128, depth_bits=32), 500, 2, None, 1024, None),
    ("runs-off", dict(screen_size=128, center_sampled_runs=False,
                      opacity_aware_extents=False), 500, 2, None, 8192, None),
    ("huge-below", dict(screen_size=1024), 192, 9, HUGE_KW, 262144, None),
    ("huge-above", dict(screen_size=1024), 192, 9, HUGE_KW, 524288, None),
    # The cases of tests/test_torch_emit.py that a slot-parallel emission
    # can get wrong: one splat over many 128-slot blocks, a long run of
    # columns that own nothing, the capacity cutting a splat in a packed
    # run and in its fallthrough rows, splats wider than 63 tiles among
    # ordinary ones.
    ("splat-spans-blocks", dict(screen_size=1024), 12, 9, HUGE_KW, 32896, None),
    ("culled-run", dict(screen_size=128), 3000, 5, None, 4096, cull_run(200, 2900)),
    ("cut-in-packed-run", dict(screen_size=128), 500, 2, None, 640, None),
    ("cut-in-fallthrough", dict(screen_size=1024), 12, 9, HUGE_KW, 8192, None),
    ("wide-beside-ordinary", dict(screen_size=1024), 300, 3, None, 43008, widen(150, 151)),
]


@pytest.mark.parametrize("name,cfg_kw,n,seed,scene_kw,capacity,edit", EMIT_CASES,
                         ids=[c[0] for c in EMIT_CASES])
def test_interleave_and_emit_match_plain(dev, name, cfg_kw, n, seed, scene_kw, capacity, edit):
    cfg = pt.RenderConfig(**cfg_kw)
    cols, incl = stage_c_inputs(dev, n, seed, cfg, scene_kw, edit)
    before = (expand.interleave_rows.launches, expand.emit_slots.launches)
    rows = expand.interleave_rows(incl, cols, capacity + 1)
    torch.testing.assert_close(bits(rows), bits(expand._interleave_rows_torch(incl, cols,
                                                                             capacity + 1)),
                               rtol=0, atol=0)
    outs = expand.emit_slots(rows, capacity, cfg)
    torch.cuda.synchronize()
    for got, want in zip(outs, expand._emit_torch(rows, capacity, cfg)):
        assert torch.equal(got, want)
    assert (expand.interleave_rows.launches, expand.emit_slots.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("case", SPLAT_CASES, ids=[c[0] for c in SPLAT_CASES])
def test_splat_columns_match_plain(dev, case):
    """The per-splat kernel against its plain version on the same card: the
    counts and every column but rgb bit for bit, rgb within one level a
    channel (cuBLAS sums the plain SH contraction in its own order)."""
    scene, cam, config, band = splat_case(case, dev)
    before = splat.splat_columns.launches
    cols, counts = splat.splat_columns(scene, cam, config, row_band=band)
    torch.cuda.synchronize()
    assert splat.splat_columns.launches == before + 1
    want_cols, want_counts = splat._splat_columns_torch(scene, cam, config, band)
    assert torch.equal(counts, want_counts)
    for i, (got, want) in enumerate(zip(cols, want_cols)):
        if i != splat.RGB_COLUMN:
            assert torch.equal(column_bits(got), column_bits(want)), f"column {i}"
    got_rgb = cols[splat.RGB_COLUMN].to(torch.int64)
    want_rgb = want_cols[splat.RGB_COLUMN].to(torch.int64)
    for shift in (16, 8, 0):
        level = ((got_rgb >> shift) & 255) - ((want_rgb >> shift) & 255)
        assert int(level.abs().max()) <= 1


def test_splat_columns_reject_bad_arguments(dev):
    import dataclasses

    scene, cam, config, _ = splat_case(SPLAT_CASES[0], dev)
    bad_scenes = {
        "is on cpu": dataclasses.replace(scene, scales=scene.scales.cpu()),
        "dtype": dataclasses.replace(scene, opacities=scene.opacities.double()),
        "sh has shape": dataclasses.replace(scene, sh=scene.sh[:, :9]),
        "contiguous": dataclasses.replace(scene, means=scene.means.t().contiguous().t()),
    }
    for match, bad in bad_scenes.items():
        with pytest.raises(ValueError, match=match):
            splat.splat_columns(bad, cam, config)
    with pytest.raises(ValueError, match="camera position"):
        splat.splat_columns(scene, dict(cam, position=cam["position"].cpu()), config)
    with pytest.raises(ValueError, match="dtype"):
        splat.splat_columns(scene, cam, config,
                            row_band=(torch.tensor(0, device=dev), torch.tensor(9, device=dev)))
    with pytest.raises(ValueError, match="shape"):
        splat.splat_columns(scene, cam, config, row_band=(
            torch.zeros(1, dtype=torch.int32, device=dev), 9))


def test_splat_columns_read_a_camera_of_separate_tensors(dev):
    """A camera dict that is no view of one buffer is gathered into one on
    the card: the same columns as from camera_tensors' views."""
    scene, cam, config, _ = splat_case(SPLAT_CASES[0], dev)
    separate = {k: v.clone() for k, v in cam.items()}
    want = splat.splat_columns(scene, cam, config)
    got = splat.splat_columns(scene, separate, config)
    assert torch.equal(got[1], want[1])
    for g, w in zip(got[0], want[0]):
        assert torch.equal(column_bits(g), column_bits(w))


@pytest.mark.parametrize("num_probes,shift,n", [(4097, 19, 100_000), (65, 0, 777), (2, 0, 3)])
def test_edges_match_plain(dev, num_probes, shift, n):
    rng = np.random.default_rng(n)
    keys = np.sort(rng.integers(0, (num_probes + 2) << shift, n, dtype=np.uint64))
    keys = np.concatenate([keys, np.full(100, 0xFFFFFFFF, np.uint64)]).astype(np.uint32)
    k = torch.from_numpy(keys.view(np.int32)).to(dev)
    got = ranges.tile_edges(k, num_probes, shift)
    assert torch.equal(got, ranges._edges_torch(k, num_probes, shift))


def test_segmented_edges_match_plain(dev):
    """Keys sorted within each of 16 segments only, sentinels at the end of
    every segment: the layout of a band-sorted list."""
    segments, seg, num_probes, shift = 16, 20_000, 4097, 19
    rng = np.random.default_rng(7)
    parts = []
    for s_ in range(segments):
        lo, hi = s_ * 256, (s_ + 1) * 256
        live = int(rng.integers(0, seg))
        k = np.sort(rng.integers(lo << shift, hi << shift, live, dtype=np.uint64))
        parts.append(np.concatenate([k, np.full(seg - live, 0xFFFFFFFF, np.uint64)]))
    k = torch.from_numpy(np.concatenate(parts).astype(np.uint32).view(np.int32)).to(dev)
    before = ranges.tile_edges.launches
    got = ranges.tile_edges(k, num_probes, shift, segments=segments)
    assert ranges.tile_edges.launches == before + 1
    assert got.shape == (segments, num_probes)
    assert torch.equal(got, ranges._edges_torch(k, num_probes, shift, segments=segments))
    # A flat pass over the same keys would be wrong: they are not globally sorted.
    assert not torch.equal(ranges.tile_edges(k, num_probes, shift),
                           ranges._edges_torch(k, num_probes, shift))


@pytest.mark.parametrize("name", list(EDGE_CORNER_CASES))
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "view-4-bytes-off"])
def test_edges_corner_cases_match_plain(dev, name, offset):
    """K1 on its corner cases, bit for bit; with ``offset`` the keys are a
    view that starts 4 bytes past a 16-byte boundary (the scalar path)."""
    keys, segments, num_probes, shift = edge_corner_keys(name)
    buf = torch.from_numpy(np.concatenate([np.zeros(offset, np.uint32), keys]).view(np.int32))
    k = buf.to(dev)[offset:]
    assert (k.data_ptr() % 16 == 0) == (offset == 0)
    got = ranges.tile_edges(k, num_probes, shift, segments=segments)
    torch.cuda.synchronize()
    assert torch.equal(got, ranges._edges_torch(k, num_probes, shift, segments=segments))


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "view-4-bytes-off"])
def test_edges_main_path_size_match_plain(dev, offset):
    """K1 over as many keys as the main path's list, where the fixed grid
    strides over many tiles a block, aligned and 4 bytes off."""
    rng = np.random.default_rng(3)
    keys = np.sort(rng.integers(0, 4099 << 19, 3_900_000, dtype=np.uint64)).astype(np.uint32)
    buf = torch.from_numpy(np.concatenate([np.zeros(offset, np.uint32), keys]).view(np.int32))
    k = buf.to(dev)[offset:]
    got = ranges.tile_edges(k, 4097, 19)
    torch.cuda.synchronize()
    assert torch.equal(got, ranges._edges_torch(k, 4097, 19))


# (name, config, splats, seed, scene, band rows, capacity, compact capacity)
BANDED_CASES = [
    ("g4", dict(screen_size=128, sort_bands=4), 500, 2, None, [0, 2, 4, 6, 8], 8192, 2048),
    ("g4-lex-rows", dict(screen_size=128, sort_bands=4, depth_bits=32), 500, 2, None,
     [0, 3, 4, 6, 8], 8192, 2048),
    ("g4-pair-saturated", dict(screen_size=128, sort_bands=4), 500, 2, None, [0, 2, 4, 6, 8],
     1024, 2048),
    ("g4-compact-saturated", dict(screen_size=128, sort_bands=4), 500, 2, None, [0, 2, 4, 6, 8],
     8192, 512),
    ("g16-huge", dict(screen_size=1024, sort_bands=16), 192, 9, HUGE_KW, None, 1048576,
     16 * 1024),
    ("g16-huge-pair-saturated", dict(screen_size=1024, sort_bands=16), 192, 9, HUGE_KW, None,
     16 * 15360, 16 * 1024),
    ("g16-huge-compact-saturated", dict(screen_size=1024, sort_bands=16), 192, 9, HUGE_KW, None,
     1048576, 16 * 128),
]


@pytest.mark.parametrize("name,cfg_kw,n,seed,scene_kw,rows,capacity,ccap", BANDED_CASES,
                         ids=[c[0] for c in BANDED_CASES])
def test_banded_kernels_match_plain(dev, name, cfg_kw, n, seed, scene_kw, rows, capacity, ccap):
    """K5, K6, K7 and K8, each on the arrays the banded emission hands it."""
    cfg = pt.RenderConfig(**cfg_kw)
    g = cfg.sort_bands
    scene = pt.random_scene(n, seed=seed, device=dev, **(scene_kw or {})).pad_to_multiple(256)
    cam = pt.Camera(aspect=cfg.aspect).framed(scene.bounds_min, scene.bounds_max)
    c = camera_tensors(cam.camera_data(), dev)
    clip = project_splats(scene.means, scene.scales, scene.quats, c, cfg,
                          opacities=scene.opacities)
    rects = splat_tile_rects(clip, cfg)
    packs = splat_row_packs(clip, rects, cfg)
    band_rows = _band_rows_tensor(rows, cfg, dev)
    counts = banded.band_counts(rects, packs, band_rows)
    assert torch.equal(counts.sum(0).to(torch.int32), packs.counts)
    cols = tuple(x.contiguous() for x in pack_columns(clip, scene.colors, scene.opacities, cfg,
                                                       rects, packs))
    pre = banded.band_prefixes(counts, capacity // g, ccap // g)
    assert (int(pre.band_totals.max()) > capacity // g) == ("pair-saturated" in name)
    assert (int(pre.band_splats.max()) > ccap // g) == ("compact-saturated" in name)
    block = banded.banded_block(capacity, ccap, g)
    np_cols = banded.padded_width(counts.shape[1])
    zeros = torch.zeros(counts.shape[1], device=dev)
    counted = (banded.interleave_rows_padded, banded.stack_rows, banded.compact_rows,
               expand.emit_slots_banded)
    before = [fn.launches for fn in counted]

    k5_in = (zeros, zeros) + cols
    full = banded.interleave_rows_padded(k5_in, np_cols)
    assert torch.equal(bits(full), bits(banded._interleave_rows_padded_torch(k5_in, np_cols)))
    k6_in = banded.band_prefix_columns(pre, np_cols)
    pfx = banded.stack_rows(k6_in)
    assert torch.equal(bits(pfx), bits(banded._stack_rows_torch(k6_in)))
    comp = banded.compact_rows(full, pfx, pre.pair_end, ccap)
    assert torch.equal(bits(comp), bits(banded._compact_rows_torch(full, pfx, pre.pair_end, ccap)))
    outs = expand.emit_slots_banded(comp, capacity, cfg, pre.pair_end, band_rows, block)
    torch.cuda.synchronize()
    want = expand._emit_torch(comp, capacity, cfg, block=block, pair_end=pre.pair_end,
                              band_rows=band_rows)
    for got_w, want_w in zip(outs, want):
        assert torch.equal(got_w, want_w)
    assert [fn.launches - b for fn, b in zip(counted, before)] == [1, 1, 1, 1]
    emitted = int((outs[expand.OUT_VALUES] >= 0).sum())
    assert (emitted == int(pre.band_totals.sum())) == ("saturated" not in name)


# (name, config, tile-row offset, (splats, seed, scene), capacity)
SMALL = (500, 2, None)
RASTER_CASES = [
    ("gaussian", dict(screen_size=128), 0, SMALL, 8192),
    ("epanechnikov-background", dict(screen_size=128, falloff="epanechnikov",
                                     background=(1.0, 1.0, 1.0)), 0, SMALL, 8192),
    ("row-offset", dict(screen_size=128, background=(0.2, 0.4, 0.6)), 3, SMALL, 8192),
    ("chunk256-rect", dict(screen_size=192, screen_height=128, raster_chunk=256), 0, SMALL, 8192),
    # 1024 pixels a tile, and 64: fewer pixels than a warp has threads.
    ("tile32", dict(screen_size=128, tile_size=32), 0, SMALL, 8192),
    ("tile8-epanechnikov", dict(screen_size=128, tile_size=8, falloff="epanechnikov"), 0, SMALL,
     32768),
    ("tile8", dict(screen_size=128, tile_size=8), 0, SMALL, 32768),
    # Lists several batches deep, where the vote ends tiles mid-list.
    ("deep-list", dict(screen_size=1024), 0, (192, 9, HUGE_KW), 524288),
    ("deep-list-chunk256", dict(screen_size=1024, raster_chunk=256, background=(0.0, 0.0, 0.0)),
     0, (768, 9, HUGE_KW), 2097152),
    # Larger tiles: 36x36, 48x48 and 64x64 (four pixels a group, 324 to
    # 1,024 groups), 128x128 and a 256x256 screen as one tile (4,096 and
    # 16,384 groups); deep lists, where one vote ends a tile of many groups;
    # a band of them from row 1.
    ("tile36", dict(screen_size=144, tile_size=36), 0, SMALL, 8192),
    ("tile48-epanechnikov", dict(screen_size=192, tile_size=48, falloff="epanechnikov"), 0,
     SMALL, 8192),
    ("tile64", dict(screen_size=256, tile_size=64), 0, SMALL, 8192),
    ("tile128-background", dict(screen_size=256, tile_size=128, background=(0.2, 0.4, 0.6)), 0,
     SMALL, 8192),
    ("tile256", dict(screen_size=256, tile_size=256), 0, SMALL, 8192),
    ("tile128-deep-list", dict(screen_size=1024, tile_size=128), 0, (192, 9, HUGE_KW), 524288),
    ("tile36-deep-list", dict(screen_size=1008, tile_size=36), 0, (192, 9, HUGE_KW), 524288),
    ("tile128-row-offset", dict(screen_size=512, tile_size=128, background=(1.0, 1.0, 1.0)), 1,
     SMALL, 8192),
    # Tile edges that 4 does not divide, a pixel a group: 30x30 (900 groups,
    # within one block), 34x34 and 50x50 (1,156 and 2,500 groups); a deep
    # list of 50x50 tiles.
    ("tile30", dict(screen_size=120, tile_size=30), 0, SMALL, 8192),
    ("tile34-epanechnikov", dict(screen_size=136, tile_size=34, falloff="epanechnikov"), 0,
     SMALL, 8192),
    ("tile50", dict(screen_size=200, tile_size=50), 0, SMALL, 8192),
    ("tile50-deep-list", dict(screen_size=1000, tile_size=50), 0, (192, 9, HUGE_KW), 524288),
    ("tile30-deep-list-background", dict(screen_size=990, tile_size=30, background=(1.0, 1.0, 1.0)),
     0, (192, 9, HUGE_KW), 524288),
]
# The tile sizes against the plain version within one level: every case but
# the 16x16 defaults of other settings and the older deep lists, which keep
# K4_LSB_BOUND.
K4_TILE_LSB = 1


@pytest.mark.parametrize("name,cfg_kw,row_offset,scene_args,capacity", RASTER_CASES,
                         ids=[c[0] for c in RASTER_CASES])
def test_raster_matches_plain(dev, name, cfg_kw, row_offset, scene_args, capacity):
    cfg = pt.RenderConfig(**cfg_kw)
    n, seed, scene_kw = scene_args
    scene = pt.random_scene(n, seed=seed, device=dev, **(scene_kw or {})).pad_to_multiple(256)
    cam = pt.Camera(aspect=cfg.aspect).framed(scene.bounds_min, scene.bounds_max)
    _, attrs, starts, counts = _frame_pairs(scene, camera_tensors(cam.camera_data(), dev),
                                            cfg, capacity)
    pair_data = raster.pack_pair_data(attrs, cfg.raster_chunk)
    rows = 2 if row_offset else cfg.tiles_y
    sl = slice(row_offset * cfg.tiles_x, (row_offset + rows) * cfg.tiles_x)
    args = (pair_data, starts[sl].contiguous(), counts[sl].contiguous(), cfg)
    before = raster.rasterize_tiles.launches
    got = raster.rasterize_tiles(*args, num_tiles=rows * cfg.tiles_x, tile_row_offset=row_offset)
    assert raster.rasterize_tiles.launches == before + 1
    blended = torch.zeros(1, dtype=torch.int32, device=dev)
    want = raster._raster_torch(*args, rows * cfg.tiles_x, row_offset, blended)
    a = raster.tiles_to_image(got, cfg).int()
    b = raster.tiles_to_image(want, cfg).int()
    bound = K4_TILE_LSB if name.startswith(("tile", "gaussian")) else K4_LSB_BOUND
    assert int((a - b).abs().max()) <= bound
    assert int(b[..., :3].max()) > 0
    if "deep-list" in name:
        assert int(blended) < int(counts[sl].sum())


@pytest.mark.parametrize("row_offset", [0, 3])
def test_k4_row_offset_pointer_matches_int(dev, row_offset):
    """K4 with the band's first tile row as a 0-d int32 tensor on the card,
    which the kernel reads from device memory, equal bit for bit to the
    same offset as a launch argument, and against its plain version by
    K4_LSB_BOUND; a background makes every pixel's transmittance show."""
    row_offset_pointer_case(dev, pt.RenderConfig(screen_size=128, background=(0.2, 0.4, 0.6)),
                            row_offset, 3, K4_LSB_BOUND)


def test_k4_row_offset_pointer_at_an_odd_tile_edge(dev):
    """The same at 50x50 tiles (a pixel a group, more than a block's
    1,024 threads): rows 1 and 2 of a 200x200 screen."""
    row_offset_pointer_case(
        dev, pt.RenderConfig(screen_size=200, tile_size=50, background=(0.2, 0.4, 0.6)),
        1, 2, K4_TILE_LSB)


# Deep lists under a background, so that channel 3 is each pixel's T: tiles
# split over a cluster whose bands are not opaque together.
CLUSTER_VOTE_CASES = [
    ("tile64", dict(screen_size=1024, tile_size=64, background=(1.0, 1.0, 1.0))),
    ("tile50", dict(screen_size=1000, tile_size=50, background=(1.0, 1.0, 1.0))),
]
# A pixel's T against the plain version's, relative, where it is above
# CLUSTER_VOTE_T_FLOOR: the kernel's ex2.approx and fused multiply-adds
# against exp, over lists some hundred pairs deep; a band that stopped a
# batch early would be off by the factor that batch multiplies T by.
CLUSTER_VOTE_T_RTOL, CLUSTER_VOTE_T_FLOOR = 1e-2, 1e-6


@pytest.mark.parametrize("name,cfg_kw", CLUSTER_VOTE_CASES, ids=[c[0] for c in CLUSTER_VOTE_CASES])
def test_k4_cluster_stops_a_tile_as_one(dev, name, cfg_kw):
    """A tile split over a cluster stops where the tile's vote says: in
    tiles where one block's band is opaque and a sibling's is not, every
    block blends as far as the plain version blends the whole tile, so each
    pixel's transmittance matches it."""
    cfg = pt.RenderConfig(**cfg_kw)
    scene = pt.random_scene(192, seed=9, device=dev, **HUGE_KW).pad_to_multiple(256)
    cam = pt.Camera(aspect=cfg.aspect).framed(scene.bounds_min, scene.bounds_max)
    _, attrs, starts, counts = _frame_pairs(scene, camera_tensors(cam.camera_data(), dev),
                                            cfg, 524288)
    pair_data = raster.pack_pair_data(attrs, cfg.raster_chunk)
    got = raster.rasterize_tiles(pair_data, starts, counts, cfg)
    blended = torch.zeros(1, dtype=torch.int32, device=dev)
    want = raster._raster_torch(pair_data, starts, counts, cfg, cfg.total_tiles, 0, blended)
    assert int(blended) < int(counts.sum())
    geometry = raster.raster_geometry(cfg.tile_size, raster.max_cluster(dev.index))
    assert geometry.cluster > 1
    ts, rows = cfg.tile_size, geometry.band_rows
    t_got, t_want = got[..., 3], want[..., 3]
    by_row = t_want.view(-1, ts, ts)
    opaque = torch.stack([(by_row[:, r:r + rows] <= cfg.transmittance_eps).flatten(1).all(1)
                          for r in range(0, ts, rows)], dim=1)
    assert bool((opaque.any(1) & ~opaque.all(1)).any()), "no tile has bands apart"
    seen = t_want > CLUSTER_VOTE_T_FLOOR
    rel = ((t_got - t_want).abs() / t_want.clamp(min=CLUSTER_VOTE_T_FLOOR))[seen]
    assert float(rel.max()) <= CLUSTER_VOTE_T_RTOL
    a = raster.tiles_to_image(got, cfg).int()
    b = raster.tiles_to_image(want, cfg).int()
    assert int((a - b).abs().max()) <= K4_TILE_LSB


# K4's counter of the pairs blended before each tile's exit, against the
# plain version's count: deep lists of large splats, where tiles exit
# early, at 16x16 and 32x32 tiles (a block a tile) and 64x64 (a cluster).
K4_COUNTER_CASES = [
    ("tile16", dict(screen_size=1024)),
    ("tile32", dict(screen_size=1024, tile_size=32)),
    ("tile64", dict(screen_size=1024, tile_size=64)),
]


@pytest.mark.parametrize("name,cfg_kw", K4_COUNTER_CASES, ids=[c[0] for c in K4_COUNTER_CASES])
def test_k4_counter_equals_the_plain_count(dev, name, cfg_kw):
    """The card's count equals the plain version's exactly: one atomic a
    tile (or a cluster) after the tile's last batch."""
    cfg = pt.RenderConfig(**cfg_kw)
    scene = pt.random_scene(192, seed=9, device=dev, **HUGE_KW).pad_to_multiple(256)
    cam = pt.Camera(aspect=cfg.aspect).framed(scene.bounds_min, scene.bounds_max)
    _, attrs, starts, counts = _frame_pairs(scene, camera_tensors(cam.camera_data(), dev),
                                            cfg, 524288)
    pair_data = raster.pack_pair_data(attrs, cfg.raster_chunk)
    got = torch.zeros(1, dtype=torch.int32, device=dev)
    want = torch.zeros(1, dtype=torch.int32, device=dev)
    raster.rasterize_tiles(pair_data, starts, counts, cfg, blended=got)
    raster._raster_torch(pair_data, starts, counts, cfg, cfg.total_tiles, 0, want)
    assert 0 < int(want) < int(counts.sum())
    assert int(got) == int(want)
    geometry = raster.raster_geometry(cfg.tile_size, raster.max_cluster(dev.index))
    assert (geometry.cluster > 1) == (name == "tile64")


def row_offset_pointer_case(dev, cfg, row_offset, rows, bound):
    scene = pt.random_scene(500, seed=2, device=dev).pad_to_multiple(256)
    cam = pt.Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    _, attrs, starts, counts = _frame_pairs(scene, camera_tensors(cam.camera_data(), dev),
                                            cfg, 8192)
    sl = slice(row_offset * cfg.tiles_x, (row_offset + rows) * cfg.tiles_x)
    args = (raster.pack_pair_data(attrs, cfg.raster_chunk), starts[sl].contiguous(),
            counts[sl].contiguous(), cfg)
    t = rows * cfg.tiles_x
    offset = torch.tensor(row_offset, dtype=torch.int32, device=dev)
    before = raster.rasterize_tiles.launches
    got = raster.rasterize_tiles(*args, num_tiles=t, tile_row_offset=offset)
    want = raster.rasterize_tiles(*args, num_tiles=t, tile_row_offset=row_offset)
    assert raster.rasterize_tiles.launches == before + 2
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    plain = raster._raster_torch(*args, t, offset)
    a = raster.tiles_to_image(got, cfg).int()
    b = raster.tiles_to_image(plain, cfg).int()
    assert int((a - b).abs().max()) <= bound and int(b[..., :3].max()) > 0
    with pytest.raises(ValueError):
        raster.rasterize_tiles(*args, num_tiles=t, tile_row_offset=offset.long())


def test_wrappers_reject_bad_arguments(dev):
    keys = torch.zeros(16, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        ranges.tile_edges(keys, 4, 0)
    incl = torch.arange(8, dtype=torch.int32, device=dev)
    cols = [torch.zeros(8, device=dev)] * 12 + [torch.zeros(16, device=dev)[::2]]
    with pytest.raises(ValueError, match="contiguous"):
        expand.interleave_rows(incl, cols, 100)
    cfg = pt.RenderConfig(screen_size=64)
    pair_data = torch.zeros((4, 512), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shape"):
        raster.rasterize_tiles(pair_data, torch.zeros(3, dtype=torch.int32, device=dev),
                               torch.zeros(3, dtype=torch.int32, device=dev), cfg)


# One stage of K6's ring holds 4,096 floats and the grid has a few hundred
# blocks; a column of 1,200 stages and 37 float4 more gives every block
# several turns of its ring and the column a short last chunk.
STACK_CASES = [
    ("k1", 1, 4096, 0), ("k4", 4, 8192, 0), ("k8-odd-length", 8, 1001, 0),
    ("k3-unaligned", 3, 4096, 1), ("k3-offset-2", 3, 4096, 2), ("k3-offset-3", 3, 4096, 3),
    ("below-one-stage", 3, 1024, 0), ("one-float4", 2, 4, 0),
    ("many-turns-short-last-chunk", 3, 600 * 8192 + 4 * 37, 0),
    ("k8-many-turns", 8, 40 * 8192 + 4, 0),
    ("length-not-multiple-of-4", 3, 100 * 8192 + 2, 0),
]


@pytest.mark.parametrize("name,k,m,offset", STACK_CASES, ids=[c[0] for c in STACK_CASES])
def test_stack_rows_matches_plain(dev, name, k, m, offset):
    """Both routes of K6, bit for bit: bulk copies through shared memory when
    the length is a multiple of 4 floats and every pointer is 16-byte
    aligned, 4 bytes a thread otherwise."""
    gen = torch.Generator(device="cpu").manual_seed(k)
    cols = [torch.randn(m + offset, generator=gen).to(dev)[offset:] for _ in range(k)]
    assert all(c.is_contiguous() for c in cols)
    before = banded.stack_rows.launches
    got = banded.stack_rows(cols)
    torch.cuda.synchronize()
    assert banded.stack_rows.launches == before + 1
    assert got.shape == (k, m)
    assert torch.equal(bits(got), bits(banded._stack_rows_torch(cols)))
    assert torch.equal(got, torch.stack(cols))


# (columns, per-band compact capacity, width): three tiles of 4,096 source
# columns, the last mostly padding, and dense bands that fill the kernel's
# staging buffer more than once; then a width that is no multiple of 4.
@pytest.mark.parametrize("n,mc,np_cols", [(9000, 2048, None), (600, 128, 1751)],
                         ids=["three-tiles", "odd-width"])
@pytest.mark.parametrize("name", COMPACT_CASES)
def test_compact_rows_corner_cases_match_plain(dev, name, n, mc, np_cols):
    """K7 against its plain version, bit for bit, on the cases that decide
    which slots the kept columns own and which the fill."""
    counts = torch.from_numpy(compact_counts(name, n, mc, seed=len(name))).to(dev)
    pre = banded.band_prefixes(counts, COMPACT_CG, mc)
    kept_g = (pre.p_excl != pre.p_incl).sum(1)
    assert (int(pre.band_splats.max()) > mc) == (name == "saturated-then-roomy")
    if name == "kept-mod-4":
        assert sorted((kept_g % 4).tolist()) == [0, 1, 2, 3]
    if name == "empty-band":
        assert int(kept_g[1]) == 0
    np_cols = np_cols or banded.padded_width(n)
    gen = torch.Generator(device="cpu").manual_seed(n)
    full = torch.randn((16, np_cols), generator=gen).to(dev)
    pfx = banded.stack_rows(banded.band_prefix_columns(pre, np_cols))
    before = banded.compact_rows.launches
    got = banded.compact_rows(full, pfx, pre.pair_end, 4 * mc)
    torch.cuda.synchronize()
    assert banded.compact_rows.launches == before + 1
    want = banded._compact_rows_torch(full, pfx, pre.pair_end, 4 * mc)
    assert torch.equal(bits(got), bits(want))
    kept_slots = (got[0] != got[1]).view(4, mc)
    for g in range(4):
        k = int(kept_g[g])
        assert bool(kept_slots[g, :k].all()) and not bool(kept_slots[g, k:].any())


def test_banded_wrappers_reject_bad_arguments(dev):
    col = torch.zeros(8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        banded.stack_rows([col, torch.zeros(16, device=dev)[::2]])
    with pytest.raises(ValueError, match="dtype"):
        banded.interleave_rows_padded([col] * 14 + [col.double()], 4096)
    full = torch.zeros((16, 4096), device=dev)
    pfx = torch.zeros((3, 4 * 4096), device=dev)
    with pytest.raises(ValueError, match="dtype"):
        banded.compact_rows(full, pfx, torch.zeros(4, dtype=torch.int64, device=dev), 1024)
    with pytest.raises(ValueError, match="shape"):
        banded.compact_rows(full, pfx[:, :-1].contiguous(), torch.zeros(4, dtype=torch.int32,
                                                                        device=dev), 1024)
    cfg = pt.RenderConfig(screen_size=128, sort_bands=4)
    with pytest.raises(ValueError, match="dtype"):
        expand.emit_slots_banded(torch.zeros((16, 1024), device=dev), 4096, cfg,
                                 torch.zeros(4, dtype=torch.int32, device=dev),
                                 torch.zeros(5, dtype=torch.int64, device=dev), 256)


def test_banded_frame_on_card_matches_golden_through_the_kernels(dev):
    counted = (banded.interleave_rows_padded, banded.stack_rows, banded.compact_rows,
               expand.emit_slots_banded, ranges.tile_edges, raster.rasterize_tiles)
    before = [fn.launches for fn in counted]
    scene = pt.random_scene(500, seed=2, device=dev)
    cfg = pt.RenderConfig(screen_size=128, sort_bands=8)
    cam = pt.Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    r = pt.Renderer(scene, cfg)
    got = r.render(cam)
    assert [fn.launches - b for fn, b in zip(counted, before)] == [1] * 6
    assert int(r.last_band_totals.sum()) == r.last_candidates
    want = golden_render(scene_to_numpy(scene), cam.camera_data(), cfg)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert (diff > 8).any(axis=-1).mean() <= 0.02
    flat = pt.Renderer(scene, pt.RenderConfig(screen_size=128)).render(cam)
    assert np.abs(flat.astype(np.int32) - got.astype(np.int32)).max() <= 2


def test_frame_on_card_matches_golden_through_the_kernels(dev):
    counted = (splat.splat_columns, ranges.tile_edges, expand.interleave_rows,
               expand.emit_slots, raster.rasterize_tiles)
    before = [fn.launches for fn in counted]
    scene = pt.random_scene(500, seed=2, device=dev)
    cfg = pt.RenderConfig(screen_size=128)
    cam = pt.Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    got = pt.Renderer(scene, cfg).render(cam)
    assert [fn.launches - b for fn, b in zip(counted, before)] == [1, 1, 1, 1, 1]
    want = golden_render(scene_to_numpy(scene), cam.camera_data(), cfg)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert (diff > 8).any(axis=-1).mean() <= 0.02


TILE_FRAME_CASES = [
    ("tile36", dict(screen_size=144, tile_size=36)),
    ("tile48", dict(screen_size=192, tile_size=48)),
    ("tile64", dict(screen_size=256, tile_size=64)),
    ("tile128", dict(screen_size=256, tile_size=128)),
    ("tile64-banded", dict(screen_size=256, tile_size=64, sort_bands=2)),
    ("tile50", dict(screen_size=200, tile_size=50)),
]


@pytest.mark.parametrize("name,cfg_kw", TILE_FRAME_CASES, ids=[c[0] for c in TILE_FRAME_CASES])
def test_renderer_at_tile_size_on_card(dev, name, cfg_kw):
    """Renderer.render at a tile size above 32x32 on the card, three frames
    at one key (eager, captured, replayed), byte-equal to each other and to
    the CPU's frame within the image rule, the first through K4, and within
    the image rule of golden.py."""
    from torch_port_cases import TILE_SIZE_CAPACITY, TILE_SIZE_SPLATS, image_close

    scene = pt.random_scene(TILE_SIZE_SPLATS, seed=2, device=dev)
    cfg = pt.RenderConfig(capacity=TILE_SIZE_CAPACITY, **cfg_kw)
    cam = pt.Camera(aspect=cfg.aspect).framed(scene.bounds_min, scene.bounds_max)
    r = pt.Renderer(scene, cfg)
    before = raster.rasterize_tiles.launches
    frames, methods = [], []
    for _ in range(3):
        frames.append(r.render(cam))
        methods.append(r.last_method)
    assert methods == ["eager", "capture", "replay"]
    assert raster.rasterize_tiles.launches > before
    for i in (1, 2):
        np.testing.assert_array_equal(frames[i], frames[0], err_msg=methods[i])
    assert frames[0][..., 3].max() == 255
    cpu = pt.Renderer(scene.to("cpu"), cfg, device="cpu").render(cam)
    image_close(frames[0], cpu, msg=f"{name} card vs CPU")
    image_close(frames[0], golden_render(scene_to_numpy(scene), cam.camera_data(), cfg),
                msg=f"{name} vs golden")


@pytest.mark.parametrize("cfg_kw", [dict(screen_size=256, tile_size=64, balanced_bands=True),
                                    dict(screen_size=144, tile_size=36),
                                    dict(screen_size=136, tile_size=34, balanced_bands=True)],
                         ids=["tile64-balanced", "tile36", "tile34-balanced"])
def test_distributed_renderer_at_tile_size_on_card(dev, cfg_kw):
    """DistributedRenderer in a world-size-1 NCCL group at a tile size above
    32x32 (K4 reads the band's first row from device memory when the bands
    are balanced): eager, captured and replayed frames byte-equal to
    Renderer.render's."""
    from cudagaussianrenderer_torch.parallel import launch
    from torch_port_cases import tile_size_sharded_case

    frames, methods, want = launch.spawn(tile_size_sharded_case, 1, "cuda", cfg_kw, 3)[0]
    assert methods == ["eager", "capture", "replay"]
    for got, method in zip(frames, methods):
        np.testing.assert_array_equal(got, want, err_msg=method)


def test_scene_ops_on_card_match_cpu(dev):
    """Every scene op on the card gives the CPU's scene (tests/
    test_torch_scene_ops.py holds the CPU's against the JAX package), the
    rotated means within an ulp or two (cuBLAS may fuse the f64 3x3 product)."""
    from cudagaussianrenderer_torch import scene_ops

    cpu = pt.random_scene(300, seed=4, sh_degree=2, device="cpu").pad_to_multiple(256)
    card = cpu.to(dev)
    ops = [
        lambda s: scene_ops.take(s, [3, 1, 299, 3]),
        lambda s: scene_ops.crop(s, (-2, -2, -2), (2, 2, 2)),
        lambda s: scene_ops.filter_opacity(s, 0.3),
        lambda s: scene_ops.decimate(s, 50),
        lambda s: scene_ops.decimate(s, 50, mode="random", seed=2),
        lambda s: scene_ops.merge([s, pt.random_scene(20, seed=5, device=s.device)]),
        lambda s: scene_ops.transform(s, translate=(1, 2, 3), scale=-1.5),
        lambda s: scene_ops.transform(s, rotate_xyzw=np.array([0.1, -0.4, 0.3, 0.85])),
    ]
    for i, op in enumerate(ops):
        want, got = op(cpu), op(card)
        assert got.device.type == "cuda", i
        assert (got.count, got.sh_degree) == (want.count, want.sh_degree), i
        for f in ("scales", "quats", "opacities", "colors", "sh"):
            a, b = getattr(got, f), getattr(want, f)
            assert (a is None) == (b is None) and (a is None or torch.equal(a.cpu(), b)), (i, f)
        torch.testing.assert_close(got.means.cpu(), want.means, rtol=2.5e-7, atol=0)



@pytest.mark.parametrize("cfg_kw", [dict(screen_size=128),
                                    dict(screen_size=128, background=(1.0, 1.0, 1.0))],
                         ids=["flat", "background"])
def test_graphed_orbit_equals_eager(dev, cfg_kw):
    """The bench's CUDA graph: two orbit frames at 128x128 replayed from one
    capture (after an eager frame under the sync debug mode "error") are
    byte-equal to the eager frames of their cameras; the wrappers count the
    capture, not the replays."""
    from cudagaussianrenderer_torch.bench import GraphedOrbit

    scene = pt.random_scene(2000, seed=0, min_scale=0.002, max_scale=0.053,
                            device=dev).pad_to_multiple(4096)
    cfg = pt.RenderConfig(**cfg_kw)
    cams = pt.orbit_cameras(scene.bounds_min, scene.bounds_max, 2)
    eager = [pt.render_frame(scene, c.camera_data(), cfg, 131072) for c in cams]
    counted = (ranges.tile_edges, expand.interleave_rows, expand.emit_slots,
               raster.rasterize_tiles)
    graphed = GraphedOrbit(scene, cams, cfg, 131072, dev)
    before = [fn.launches for fn in counted]
    for _ in range(2):
        stats, images = graphed.run(images=True)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counted] == before
    for (want, aux), got, st in zip(eager, images, stats.tolist()):
        assert torch.equal(got, want)
        assert st == [int(aux["num_pairs"]), int(aux["num_candidates"])]


def recorded_frames(dev):
    """A Renderer's frames of one camera at one key: the first settles the
    capacity, then eager, capture and three replays.  Returns (the
    renderer, the records of the last five, their methods)."""
    scene = pt.random_scene(3000, seed=0, min_scale=0.002, max_scale=0.053, sh_degree=3,
                            device=dev)
    cam = pt.orbit_cameras(scene.bounds_min, scene.bounds_max, 1)[0]
    r = pt.Renderer(scene, pt.RenderConfig(screen_size=128))
    r.render(cam)
    methods = []
    for _ in range(5):
        r.render(cam)
        methods.append(r.last_method)
    assert methods == ["eager", "capture", "replay", "replay", "replay"], methods
    return r, telemetry.frames()[-5:], methods


def test_replayed_graph_writes_a_new_ring_row(dev):
    """Each replay of a captured frame writes its stamps into a row of its
    own, with no host call: the row comes with the camera, the rows follow
    each other, every stage's span is positive and each frame's stamps come
    after the frame before it; each frame's device span lies inside its
    host frame span, and every frame counts the same pairs blended."""
    r, recs, _ = recorded_frames(dev)
    assert (recs["renderer"] == r._record.id).all()
    assert np.diff(recs["ring"]).tolist() == [1, 1, 1, 1]
    assert r._record.ring.count == recs["ring"][-1] + 1
    assert int(r._inputs[-1]) == recs["ring"][-1] % telemetry.RING_ROWS
    stamps = recs["device"]
    assert (np.diff(stamps, axis=1) >= 0).all() and (telemetry.stage_ns(recs) >= 0).all()
    assert (stamps[1:, 0] > stamps[:-1, -1]).all()
    spans = telemetry.device_span_ns(recs)
    assert (spans > 0).all() and (spans <= telemetry.span_ns(recs, "frame")).all()
    counters = recs["counters"]
    assert (counters == counters[0]).all()
    candidates, pairs, blended = counters[0]
    assert 0 < blended <= pairs == candidates


def test_capture_spans_sum_to_the_capture_span(dev):
    """A captured frame's five spans (warm-up, sync, flush, record,
    instantiate) run end to end inside its capture span and sum to it
    within 1%; its first replay and its readback follow."""
    _, recs, methods = recorded_frames(dev)
    rec = recs[methods.index("capture")]
    host = rec["host"]
    parts = ["capture.warmup", "capture.sync", "capture.flush", "capture.record",
             "capture.instantiate"]
    spans = [host[telemetry.SPANS.index(p)] for p in parts]
    c0, c1 = host[telemetry.CAPTURE]
    assert c0 <= spans[0][0] and spans[-1][1] <= c1
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    total = sum(t1 - t0 for t0, t1 in spans)
    assert abs(total - (c1 - c0)) <= 0.01 * (c1 - c0)
    assert c1 <= host[telemetry.REPLAY][0] <= host[telemetry.READBACK][0]


def test_replays_read_the_camera_refilled_in_place(dev):
    """One key over an orbit: its first frame eager, its second captured,
    then replays, each with another camera copied into the renderer's
    static buffer.  The per-splat kernel reads the camera there, so every
    frame equals the eager frame of its own camera, and the replays launch
    no kernel from the host."""
    from torch_port_cases import eager_render

    import copy

    scene = pt.random_scene(3000, seed=0, min_scale=0.002, max_scale=0.053, sh_degree=3,
                            device=dev)
    cams = pt.orbit_cameras(scene.bounds_min, scene.bounds_max, 6)
    r = pt.Renderer(scene, pt.RenderConfig(screen_size=128))
    r.render(cams[0])
    key = 2 * r._key()
    methods, launches = [], []
    for c in cams:
        r.capacity = key
        twin = copy.copy(r)
        before = splat.splat_columns.launches
        got = r.render(c)
        methods.append(r.last_method)
        launches.append(splat.splat_columns.launches - before)
        assert np.array_equal(got, eager_render(twin, c, key, None)), methods[-1]
    assert methods == ["eager", "capture", "replay", "replay", "replay", "replay"]
    assert launches[2:] == [0, 0, 0, 0] and launches[0] == 1


@pytest.mark.parametrize("cfg_kw,sh", [(dict(screen_size=128), 3), (dict(screen_size=128), 0),
                                       (dict(screen_size=256, sort_bands=16), 3),
                                       (dict(screen_size=256, sort_bands=16), 0)],
                         ids=["flat-sh3", "flat-sh0", "banded16-sh3", "banded16-sh0"])
def test_graphed_renderer_equals_eager(dev, cfg_kw, sh):
    """Renderer.render over an orbit with its keys interleaved A, B, A, B,
    A, B, A: a key's first frame eager, its second captured, later ones
    replayed from graphs that share one memory pool.  Every frame equals
    render_frame at its key and band rows byte for byte, and the state it
    leaves equals the eager controller's."""
    import copy

    from torch_port_cases import eager_render, renderer_state

    scene = pt.random_scene(3000, seed=0, min_scale=0.002, max_scale=0.053, sh_degree=sh,
                            device=dev)
    cams = pt.orbit_cameras(scene.bounds_min, scene.bounds_max, 7)
    r = pt.Renderer(scene, pt.RenderConfig(**cfg_kw))
    r.render(cams[0])
    a = r._key()
    b = (a[0], 2 * a[1]) if r.banded else 2 * a
    methods = []
    for i, key in enumerate([a, b, a, b, a, b, a]):
        if r.banded:
            r.capacity, r.compact_capacity = key
        else:
            r.capacity = key
        twin = copy.copy(r)
        rows = None if r.band_rows is None else r.band_rows.copy()
        got = r.render(cams[i])
        methods.append(r.last_method)
        want = eager_render(twin, cams[i], key, rows)
        assert np.array_equal(got, want), f"frame {i} ({methods[-1]})"
        assert renderer_state(r) == renderer_state(twin), f"frame {i} ({methods[-1]})"
    assert methods == ["eager", "eager", "capture", "capture", "replay", "replay", "replay"]
    assert set(r._graphs) == {a, b} and r._pool is not None


def test_banded_sh3_frame_is_sync_free(dev):
    """One banded SH-3 frame (K5-K8, the [G, N] prefix math, the batched
    sort) under torch.cuda.set_sync_debug_mode("error"): no host sync and no
    host-to-device copy inside, so a capture of it holds no stale value."""
    from cudagaussianrenderer_torch.render import render_frame_tensors, run_sync_free

    scene = pt.random_scene(3000, seed=0, sh_degree=3, device=dev).pad_to_multiple(4096)
    cfg = pt.RenderConfig(screen_size=256, sort_bands=16)
    cam = camera_tensors(pt.Camera(aspect=1.0).framed(scene.bounds_min,
                                                      scene.bounds_max).camera_data(), dev)
    rows = _band_rows_tensor(None, cfg, dev)
    image, aux = run_sync_free(lambda: render_frame_tensors(scene, cam, cfg, 1 << 18,
                                                            band_rows=rows))
    assert image.shape == (256, 256, 4) and int(aux["num_candidates"]) > 0


def test_ssim_on_card_with_tf32_allowed_matches_cpu(dev):
    """diff.ssim gives float32 results on the card whatever the TF32 flags
    say: within 1e-5 of the CPU, and within [-1, 1] on a flat image."""
    from cudagaussianrenderer_torch.diff import ssim

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        rng = np.random.default_rng(0)
        a = rng.uniform(0, 1, (256, 192, 3)).astype(np.float32)
        b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
        flat = np.full(a.shape, 0.5, np.float32)
        for x, y in ((a, b), (a, a), (flat, flat), (flat, b)):
            got = ssim(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
            want = ssim(torch.from_numpy(x), torch.from_numpy(y))
            assert got.device.type == "cuda"
            assert abs(float(got) - float(want)) <= 1e-5
            assert -1.0 <= float(got) <= 1.0
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


# The differentiable path on the card against the CPU, on the same inputs and
# the same pair structure: image and depth within DIFF_IMG_TOL; each gradient
# within DIFF_GRAD_RTOL of its leaf's largest |gradient| (the card's exp,
# log1p and matmul round otherwise); chip_smoke.py phase 11 holds the same.
DIFF_IMG_TOL, DIFF_GRAD_RTOL = 1e-5, 1e-4


def _diff_case(n=350, size=128):
    from cudagaussianrenderer_torch import diff

    scene = pt.random_scene(n, seed=3, sh_degree=3, device="cpu")
    config = pt.RenderConfig(screen_size=size)
    cam = pt.Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max).camera_data()
    return diff, diff.from_scene(scene), config, cam


def test_build_structure_on_card_matches_cpu(dev):
    """K1-K3 under build_structure: the same sids, starts, counts and
    candidate count as the plain versions on the CPU (a capacity that is a
    whole number of emit grains on both devices)."""
    diff, params, config, cam = _diff_case()
    cap = 16 * 4096
    got = diff.build_structure(diff.tree_map(lambda a: a.to(dev), params), cam, config, cap,
                               device=dev)
    want = diff.build_structure(params, cam, config, cap, device="cpu")
    for name, g, w in zip(want._fields, got, want):
        assert torch.equal(g.cpu(), w), name


def test_render_diff_and_gradients_on_card_match_cpu(dev):
    """render_diff's image and depth, and the gradient of every DiffSplats
    leaf and of a pose correction and an exposure, on the card against the
    CPU."""
    diff, params, config, cam = _diff_case()
    structure = diff.build_structure(params, cam, config, 1 << 16, device="cpu")
    k_max = max(8, diff.max_tile_count(structure))
    weights = torch.from_numpy(
        np.random.default_rng(0).normal(size=(128, 128, 3)).astype(np.float32))
    extras = (diff.CameraDeltas(dr=torch.tensor([0.01, -0.02, 0.015]),
                                dt=torch.tensor([0.05, 0.02, -0.03])),
              diff.Exposure(gain=torch.tensor([1.1, 0.9, 1.0]),
                            bias=torch.tensor([0.01, 0.0, -0.02])))

    def run(d):
        p = diff.tree_map(lambda a: a.detach().to(d).requires_grad_(True), params)
        ex = diff.tree_map(lambda a: a.detach().to(d).requires_grad_(True), extras)
        c = diff.apply_camera_delta(diff._camera(cam, d), ex[0].dr, ex[0].dt)
        image, depth, _ = diff.render_diff(p, c, config, 1 << 16, k_max,
                                           structure=diff.tree_map(lambda a: a.to(d), structure),
                                           return_depth=True, device=d)
        loss = torch.sum((image[..., :3] * ex[1].gain + ex[1].bias) * weights.to(d))
        loss = loss + torch.sum(depth)
        leaves = diff.tree_leaves(p) + diff.tree_leaves(ex)
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        return image.detach().cpu(), depth.detach().cpu(), [
            torch.zeros_like(x).cpu() if gi is None else gi.cpu() for gi, x in zip(g, leaves)]

    img_d, dep_d, g_d = run(dev)
    img_c, dep_c, g_c = run(torch.device("cpu"))
    assert float((img_d - img_c).abs().max()) <= DIFF_IMG_TOL
    assert float((dep_d - dep_c).abs().max()) <= DIFF_IMG_TOL
    assert len(g_d) == 10
    for a, b in zip(g_d, g_c):
        assert float((a - b).abs().max()) <= DIFF_GRAD_RTOL * float(b.abs().max())


def test_fit_step_on_card_matches_cpu(dev):
    """One fit step (tx_3dgs, the paper's L1 + D-SSIM loss, pose and exposure
    refinement) on the card against the CPU: the loss, and the parameters
    after the step within a tenth of the smallest rate's step."""
    diff, params, config, cam = _diff_case(n=200, size=64)
    renderer = pt.Renderer(pt.random_scene(300, seed=4, device="cpu"), config, device="cpu")
    target = renderer.render(pt.Camera(aspect=1.0).framed((-4,) * 3, (4,) * 3))[..., :3]
    # Anisotropic splats: an isotropic splat's rotation has no gradient but
    # rounding noise, which tx_3dgs's eps of 1e-15 turns into full-rate steps.
    stretch = torch.from_numpy(
        np.random.default_rng(1).normal(0, 0.4, tuple(params.log_scales.shape)).astype(np.float32))
    params = params._replace(log_scales=params.log_scales + stretch)
    kw = dict(capacity=1 << 16, k_max=256, steps=1, l1_weight=0.8, ssim_weight=0.2,
              l2_weight=0.0, optimize_cameras=True, optimize_exposure=True)
    outs = [diff.fit(params, [cam], [target], config, tx=diff.tx_3dgs(8.0, 10), device=d, **kw)
            for d in (dev, torch.device("cpu"))]
    (p_d, l_d, c_d, e_d), (p_c, l_c, c_c, e_c) = outs
    assert abs(float(l_d[0]) - float(l_c[0])) <= 1e-5 * abs(float(l_c[0]))
    for a, b in zip(diff.tree_leaves((p_d, c_d, e_d)), diff.tree_leaves((p_c, c_c, e_c))):
        assert float((a.cpu() - b).abs().max()) <= 1e-4


def _multi_device_close(got, want, msg=""):
    """tests/test_distributed.py's rule for a sharded frame against the
    single-device one (a band's list aligns the raster's early-exit chunks
    elsewhere)."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert (d > 1).mean() < 0.001, f"{msg}: max diff {d.max()}"


def test_render_band_on_card_sums_to_the_sharded_frame(dev):
    """render_band on the card, summed over 1, 2 and 4 bands, against the
    frame of render_frame_sharded in a world-size-1 NCCL group: one band
    byte-equal, and every band count with the frame's pair count."""
    from cudagaussianrenderer_torch.parallel import launch

    img, pairs, bands = launch.spawn(card_sharded_case, 1, "cuda", (1, 2, 4))[0]
    assert img.shape == (128, 128, 4) and img[..., 3].max() == 255
    np.testing.assert_array_equal(bands[1][0], img.astype(np.int32))
    for n, (total, band_pairs) in bands.items():
        assert band_pairs == pairs, n
        assert total.max() <= 255
        _multi_device_close(total.astype(np.uint8), img, f"{n} bands")


def test_fit_dp_on_card_matches_the_hand_steps(dev):
    """Two fit_dp steps of a world-size-1 NCCL group (Adam, L1 + D-SSIM)
    against the same steps by hand on the card: every parameter leaf within
    DIFF_GRAD_RTOL of its largest value, the losses within 1e-6."""
    from cudagaussianrenderer_torch.parallel import launch

    rel, got, want = launch.spawn(card_fit_dp_case, 1, "cuda", 64, 200, 2)[0]
    assert len(rel) == 5 and max(rel) <= DIFF_GRAD_RTOL, rel
    np.testing.assert_allclose(got, want, rtol=1e-6)


# Graphed training steps against their eager twins: the same kernels on the
# same inputs in the same order, pair gradients summed in float64, so the
# graphed steps are expected bit-equal (a tolerance of 0).
GRAPHED_STEP_TOL = 0.0


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_graphed_fit_steps_equal_eager_steps(dev, remat):
    """Ten steps of diff.FitStepGraphs (tx_3dgs, L1 + D-SSIM, pose and
    exposure refinement, the SH warm-up) at 128x128 against its eager twin
    from the same state: a key's first step eager, its second captured,
    later ones replayed; loss, candidates, gradient norms and every state
    leaf (parameters, optimizer state, extras) within GRAPHED_STEP_TOL."""
    from cudagaussianrenderer_torch import diff

    scene, cams, targets = rendered_views(300, 3, 128, 2, sh_degree=2)
    init = anisotropic(diff.random_init(300, scene.bounds_min, scene.bounds_max, seed=1,
                                        sh_degree=2, device="cpu"))
    config = pt.RenderConfig(screen_size=128)
    graphed, eager, inputs = fit_step_pair(init, [c.camera_data() for c in cams], targets,
                                           config, 1 << 16, 256, dev, remat=remat)
    records, diffs = run_step_pair(graphed, eager, inputs, 10)
    methods = [r[0] for r in records]
    assert methods[0] == "eager" and methods.count("capture") in (1, 2), methods
    assert methods.count("replay") >= 6, methods
    for _, lg, le, cg, ce, dn in records:
        assert abs(lg - le) <= GRAPHED_STEP_TOL and cg == ce and dn <= GRAPHED_STEP_TOL
    assert max(diffs) <= GRAPHED_STEP_TOL, diffs
    report = graphed.report()
    assert report["structure"] == {"eager": 1, "capture": 1, "replay": 8}
    assert report["memory_reserved"] > 0


def test_graphed_dp_steps_equal_eager_steps(dev):
    """Ten steps of parallel.train.DPStepGraphs (two views a step, the
    gradient all-reduce inside graph B) of a world-size-1 NCCL group against
    its eager twin: losses and every state leaf within GRAPHED_STEP_TOL."""
    from cudagaussianrenderer_torch.parallel import launch

    records, diffs, report = launch.spawn(card_graphed_dp_case, 1, "cuda", 10)[0]
    methods = [r[0] for r in records]
    assert methods[0] == "eager" and methods.count("capture") in (1, 2), methods
    assert methods.count("replay") >= 6, methods
    for _, lg, le in records:
        assert abs(lg - le) <= GRAPHED_STEP_TOL
    assert max(diffs) <= GRAPHED_STEP_TOL, diffs
    assert report["structure"].get("replay", 0) >= 7


def test_graphed_dp_steps_across_cards(dev):
    """Up to four cards, one NCCL rank each: DPStepGraphs against its eager
    twin for 6 steps, each rank keyed on its own views' block profiles
    (other keys at other steps): losses and every state leaf within
    GRAPHED_STEP_TOL on every rank, the replicas bit-identical.  Needs two
    cards or more."""
    from cudagaussianrenderer_torch.parallel import launch

    n = min(4, torch.cuda.device_count())
    if n < 2:
        pytest.skip("needs two CUDA devices or more: NCCL takes one card a rank")
    ranks = launch.spawn(dp_graph_ranks_case, n, "cuda", 6)
    for r in ranks:
        (got, got_l), (want, want_l) = r["graphed"], r["eager"]
        assert max(abs(a - b) for a, b in zip(got_l, want_l)) <= GRAPHED_STEP_TOL
        for a, b in zip(got, want):
            assert float(np.abs(a - b).max(initial=0.0)) <= GRAPHED_STEP_TOL
        assert "replay" in r["graphed_methods"], r["graphed_methods"]
        for a, b in zip(r["graphed"][0], ranks[0]["graphed"][0]):
            assert a.tobytes() == b.tobytes()
    assert len({str(r["graphed_profiles"]) for r in ranks}) > 1


def test_bench_refuses_more_ranks_than_cards(dev):
    from cudagaussianrenderer_torch import bench

    with pytest.raises(RuntimeError, match="CUDA devices"):
        bench.main(["2000", "2", "--size", "128", "--devices",
                    str(torch.cuda.device_count() + 1)])


def test_sharded_frames_across_cards(dev):
    """Up to four cards, one NCCL rank each: the sharded frames equal the
    single-card band programs byte for byte on every rank, with the
    single-card pair count, and a data-parallel step leaves bit-identical
    replicas.  Needs two cards or more."""
    from cudagaussianrenderer_torch.parallel import launch

    n = min(4, torch.cuda.device_count())
    if n < 2:
        pytest.skip("needs two CUDA devices or more: NCCL takes one card a rank")
    ranks = launch.spawn(mesh_frames_case, n, "cuda", n)
    for checks, uniform, balanced, leaves in ranks:
        assert all(checks.values()), checks
        np.testing.assert_array_equal(uniform, ranks[0][1])
        np.testing.assert_array_equal(balanced, ranks[0][2])
        for a, b in zip(leaves, ranks[0][3]):
            assert a.tobytes() == b.tobytes()


def test_balanced_render_band_is_sync_free_and_graphs(dev):
    """Every band of 4 balanced bands (3000 splats, SH 3, 256x256): the
    band's device part (render_band_tensors: bounds, binning, K4's row
    offset on the device) runs under the sync debug mode "error", is
    captured as a CUDA graph over a static camera and replayed for two
    cameras, each replay byte-equal to render_band with the same counts
    and bounds."""
    from cudagaussianrenderer_torch.parallel import render_band
    from cudagaussianrenderer_torch.parallel.distributed import render_band_tensors
    from cudagaussianrenderer_torch.render import (
        CAMERA_FLOATS, camera_array, camera_views, capture_frame, run_sync_free,
    )

    scene = pt.random_scene(3000, seed=0, min_scale=0.002, max_scale=0.053, sh_degree=3,
                            device=dev).pad_to_multiple(4096)
    cfg = pt.RenderConfig(screen_size=256, balanced_bands=True)
    cams = pt.orbit_cameras(scene.bounds_min, scene.bounds_max, 2)
    table = torch.from_numpy(np.stack([camera_array(c.camera_data()) for c in cams])).to(dev)
    camera = torch.zeros(CAMERA_FLOATS, dtype=torch.float32, device=dev)
    views = camera_views(camera)
    pool = torch.cuda.graph_pool_handle()
    for d in range(4):
        def frame():
            return render_band_tensors(scene, views, cfg, 1 << 17, 4, d)

        camera.copy_(table[0])
        eager, _ = run_sync_free(frame)
        graph, (image, aux) = capture_frame(frame, dev, pool=pool, checked=True)
        for i, c in enumerate(cams):
            camera.copy_(table[i])
            graph.replay()
            want, waux = render_band(scene, c.camera_data(), cfg, 1 << 17, 4, d, device=dev)
            assert torch.equal(image, want), (d, i)
            assert {k: int(v) for k, v in aux.items()} == {k: int(v) for k, v in waux.items()}
            assert int(aux["band_lo"]) < int(aux["band_hi"])
        assert torch.equal(eager, render_band(scene, cams[0].camera_data(), cfg, 1 << 17, 4, d,
                                              device=dev)[0])


def test_graphed_distributed_renderer_equals_eager(dev):
    """A world-size-1 NCCL group's DistributedRenderer at keys A, B, A, B,
    A, A: a key's first frame eager, its second captured (collectives
    included), later ones replayed; every frame byte-equal to
    Renderer.render of its camera, and render_batch too."""
    from cudagaussianrenderer_torch.parallel import launch

    methods, frames, want, batch, keys = launch.spawn(card_graphed_renderer_case, 1, "cuda")[0]
    assert methods == ["eager", "eager", "capture", "capture", "replay", "replay"]
    assert len(keys) == 2
    for i, (got, w) in enumerate(zip(frames, want)):
        np.testing.assert_array_equal(got, w, err_msg=f"frame {i} ({methods[i]})")
    np.testing.assert_array_equal(batch, np.stack(want[:5]))


def test_renderer_renders_a_replaced_scene_on_card(dev):
    """Renderer renders scene A three times (eager, capture, replay), is
    given scene B, and its next frame (eager, the old graph dropped) is
    byte-equal to a fresh Renderer's eager frame over B at the same
    capacity; B's second and third frames capture and replay it."""
    from torch_port_cases import GRAPH_SIZE, SWAP_CAPACITY, swap_scenes

    a, b = swap_scenes(dev)
    cfg = pt.RenderConfig(screen_size=GRAPH_SIZE, capacity=SWAP_CAPACITY)
    cam = pt.Camera(aspect=1.0).framed(a.bounds_min, a.bounds_max)
    r = pt.Renderer(a, cfg)
    methods, frames = [], []
    for i in range(6):
        if i == 3:
            r.scene = b
        frames.append(r.render(cam))
        methods.append(r.last_method)
    assert methods == ["eager", "capture", "replay"] * 2
    fresh = pt.Renderer(b, cfg)
    fresh.capacity = r.capacity
    want = fresh.render(cam)
    assert fresh.last_method == "eager" and not r.saturated
    for i in (3, 4, 5):
        np.testing.assert_array_equal(frames[i], want, err_msg=f"frame {i}")
    assert not np.array_equal(frames[0], want)


def test_distributed_renderer_renders_a_replaced_scene_on_card(dev):
    """The gloo case of tests/test_torch_scene_swap.py in a world-size-1
    NCCL group: scene A eager, captured, replayed; scene B's frame and
    render_batch byte-equal to a fresh DistributedRenderer's over B."""
    from cudagaussianrenderer_torch.parallel import launch
    from torch_port_cases import scene_swap_case

    got = launch.spawn(scene_swap_case, 1, "cuda")[0]
    assert got["methods"] == ["eager", "capture", "replay", "eager"]
    assert got["saturated"] == (False, False)
    np.testing.assert_array_equal(got["swapped"], got["fresh"])
    np.testing.assert_array_equal(got["batch"], got["fresh"])
    assert not np.array_equal(got["swapped"], got["first"][0])


@pytest.mark.parametrize("name", ["single-splat", "one-tile", "huge-splat", "depth-plane"])
def test_edge_scenes_on_card(dev, name):
    """The scenes of tests/test_edge_cases.py through Renderer on the card
    (eager, capture, replay): the JAX test's assertions, every frame equal,
    the image rule against golden.py and against the CPU's frame."""
    from torch_port_cases import check_edge_frame, edge_case, image_close

    scene, cfg, cam = edge_case(name, pt, device=dev)
    r = pt.Renderer(scene, cfg)
    frames, methods = [], []
    for _ in range(3):
        frames.append(r.render(cam))
        methods.append(r.last_method)
    assert methods == ["eager", "capture", "replay"] and not r.saturated
    check_edge_frame(name, frames[0], frames[1])
    np.testing.assert_array_equal(frames[2], frames[0])
    image_close(frames[0], golden_render(scene_to_numpy(scene), cam.camera_data(), cfg),
                f"{name} against golden.py")
    cpu = pt.Renderer(scene.to("cpu"), cfg, device="cpu").render(cam)
    image_close(frames[0], cpu, f"{name} against the CPU")


def test_sh_basis_on_card_matches_cpu(dev):
    from cudagaussianrenderer_torch.ops.sh import sh_basis

    rng = np.random.default_rng(42)
    d = rng.normal(size=(4096, 3))
    d = torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))
    for degree in range(5):
        got = sh_basis(d.to(dev), degree)
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), sh_basis(d, degree), rtol=0, atol=1e-6)


@pytest.mark.parametrize("config", [1, 2, 3, 4, 5, 6])
def test_bench_suite_small_on_card(dev, config, capsys):
    """Each config of the port's bench suite small on the card (about 2,000
    splats, 2-4 frames): graphed, every graphed frame byte-equal to its
    eager frame, the card's name in its line."""
    from cudagaussianrenderer_torch.tools import bench_suite

    n_scale, size_scale = {1: (0.2, 0.25), 2: (0.02, 0.25)}.get(config, (0.002, 0.125))
    out = bench_suite.main([str(config), "--n-scale", str(n_scale), "--size-scale",
                            str(size_scale), "--frames-scale", "0.25"])
    for line, m in out:
        assert line["method"] == "cuda_graph" and line["graph_frames_equal"] == line["frames"]
        assert not line["saturated"] and line["pairs_per_frame"] > 0
        assert line["device"] != "cpu" and line["capacity"] % 4096 == 0
        if config == 1:  # a static camera
            assert set(m["frame_pairs"]) == {line["pairs_per_frame"]}


def test_fit_and_make_artifact_small_on_card(dev, tmp_path):
    """The fit and 1M-splat artifact tools small on the card."""
    from cudagaussianrenderer_torch.tools import fit_artifact, make_artifact

    rec = fit_artifact.main(["--scene-splats", "300", "--fit-splats", "300", "--views", "3",
                             "--size", "64", "--steps", "20", "--out", str(tmp_path / "fit")])
    assert rec["backend"] != "cpu" and rec["psnr_fit_db"] > rec["psnr_init_db"]
    art = make_artifact.main(["--n", "2000", "--size", "64", "--frames", "4",
                              "--out", str(tmp_path / "art")])
    assert art["importer"] == "native" and art["graph_frames_equal"] == 4
    assert (tmp_path / "art" / "artifact_1m_sh3_frame2.png").exists()


def test_measure_emit_on_card_launches_k2_and_k3(dev, capsys):
    """tools/measure.py emit at 20,000 splats: no line fails, every line
    replays a CUDA graph, and the trace of the emit line holds K2 and K3 by
    name (chip_smoke.py's TRACE_NAMES)."""
    import re

    from cudagaussianrenderer_torch.tools import measure

    res = measure.run("emit", dev, n=20_000, capacity=131_072)
    assert not res["failed"], capsys.readouterr().out[-3000:]
    assert all(ln["method"] == "cuda_graph" for ln in res["lines"]), res["lines"]
    trace = next(ln for ln in res["lines"] if ln["name"].startswith("emit kernels"))["trace"]
    for pattern in (r"::interleave_kernel\(", r"::emit_kernel<false>"):
        assert any(re.search(pattern, k) for k in trace), sorted(trace)


# Stage D's kernel path (csrc/sort.cu) against the stable int64 torch.sort
# and its gathers (sorting._sort_pairs_torch): (name, slots, live slots,
# tiles, depths).  Depths from a small range make runs of equal keys, whose
# order only a stable sort keeps; tiles past 4,095 set the key's top bit, so
# a signed sort would misorder them.
SORT_CASES = [
    ("sentinel-suffix", 70_000, 52_345, 4096, 64),
    ("all-equal", 5_000, 5_000, 1, 1),
    ("8160-tiles", 300_000, 281_003, 8160, 1 << 19),
    ("block-ragged", 1_025, 1_000, 40, 8),
    ("one-slot", 1, 1, 1, 1),
]


def sort_case_pairs(dev, n, live, tiles, depths, seed=0):
    """A TilePairs of ``n`` slots: ``live`` packed keys (tile << 19 |
    depth), then sentinels; random attribute words and splat indices, as
    rows of one [6, n] tensor, as the emit kernel leaves them."""
    rng = np.random.default_rng(seed)
    keys = np.full(n, 0xFFFFFFFF, np.uint64)
    keys[:live] = (rng.integers(0, tiles, live).astype(np.uint64) << np.uint64(19)) | (
        rng.integers(0, depths, live).astype(np.uint64) + np.uint64((1 << 19) - depths))
    rows = rng.integers(-2**31, 2**31, (6, n), dtype=np.int64).astype(np.int32)
    rows[0] = keys.astype(np.uint32).view(np.int32)
    rows = torch.from_numpy(rows).to(dev)
    return TilePairs(keys=(rows[0],), values=rows[2], attrs=(rows[3], rows[4], rows[5]),
                     num_candidates=torch.tensor(live, device=dev),
                     num_pairs=torch.tensor(live, device=dev))


def sorted_words(result):
    keys, values, attrs = result
    return list(keys) + ([] if values is None else [values]) + list(attrs)


@pytest.mark.parametrize("with_values", [False, True], ids=["attrs", "with-values"])
@pytest.mark.parametrize("name,n,live,tiles,depths", SORT_CASES, ids=[c[0] for c in SORT_CASES])
def test_sort_kernel_matches_the_stable_int64_sort(dev, name, n, live, tiles, depths,
                                                   with_values):
    """Keys, values and attribute words bit-equal to torch.sort of the key
    widened to int64 (stable) and the torch gathers; one sort and one
    gather launch, for stable and unstable calls alike."""
    pairs = sort_case_pairs(dev, n, live, tiles, depths)
    want = sorting._sort_pairs_torch(pairs, with_values=with_values, stable=True)
    for stable in (False, True):
        before = sorting.sort_words.launches
        got = sorting.sort_pairs(pairs, with_values=with_values, stable=stable)
        assert sorting.sort_words.launches == before + 1
        assert (got[1] is None) == (not with_values)
        for g, w in zip(sorted_words(got), sorted_words(want)):
            assert g.dtype == torch.int32 and torch.equal(g, w)


def test_sort_kernel_replayed_equals_eager(dev):
    """A sort captured in a CUDA graph and replayed over keys refilled in
    place equals its eager twin on the same keys."""
    from cudagaussianrenderer_torch.render import capture_frame

    pairs = sort_case_pairs(dev, 70_000, 52_345, 4096, 64)

    def frame():
        return sorting.sort_pairs(pairs, with_values=True)

    graph, out = capture_frame(frame, dev)
    for seed in (1, 2):
        fresh = sort_case_pairs(dev, 70_000, 60_000, 8160, 1 << 19, seed=seed)
        pairs.keys[0].copy_(fresh.keys[0])
        before = sorting.sort_words.launches
        graph.replay()
        assert sorting.sort_words.launches == before
        want = frame()
        for g, w in zip(sorted_words(out), sorted_words(want)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("words", [0, 1, 2, 4])
def test_sort_words_moves_any_word_count(dev, words):
    """0-4 words (the measurement harness sorts 0-3 payloads, a fit 4),
    bit-equal to the plain version on the card."""
    pairs = sort_case_pairs(dev, 70_000, 52_345, 4096, 64)
    sources = ([pairs.values] + list(pairs.attrs))[:words]
    got = sorting.sort_words(pairs.keys[0], sources)
    want = sorting._sort_words_torch(pairs.keys[0], sources)
    assert got[1].shape == (words, 70_000)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_sort_words_rejects_bad_arguments(dev):
    key = torch.zeros(64, dtype=torch.int32, device=dev)
    words = [torch.zeros(64, dtype=torch.int32, device=dev) for _ in range(5)]
    bad = [
        (key.long(), words[:3]), (key.view(8, 8), words[:3]), (key[::2], words[:3]),
        (key, [w.cpu() for w in words[:3]]), (key, [words[0][:32]] + words[1:3]),
        (key, [w.float() for w in words[:3]]), (key, [w.view(8, 8) for w in words[:3]]),
        (key, words),
    ]
    for bad_key, bad_words in bad:
        with pytest.raises(ValueError):
            sorting.sort_words(bad_key, bad_words)


def test_renderer_records_the_sort_path_its_frames_take(dev):
    """Every frame of a flat Renderer with the packed key sorts through the
    kernel: eager, capture and replays note it in their records, and the
    wrapper counts the eager frame, the capture's warm-up and the capture.
    The lex key and the banded list keep torch.sort, and say so."""
    before = sorting.sort_words.launches
    _, recs, _ = recorded_frames(dev)
    assert [telemetry.SORT_PATHS[p] for p in recs["sort_path"]] == ["kernel"] * 5
    assert sorting.sort_words.launches - before == 4  # the settling frame too
    scene = pt.random_scene(3000, seed=0, min_scale=0.002, max_scale=0.053, device=dev)
    cam = pt.orbit_cameras(scene.bounds_min, scene.bounds_max, 1)[0]
    for cfg in (pt.RenderConfig(screen_size=128, depth_bits=32),
                pt.RenderConfig(screen_size=128, sort_bands=2)):
        r = pt.Renderer(scene, cfg)
        before = sorting.sort_words.launches
        methods = []
        for _ in range(6):
            r.render(cam)
            methods.append(r.last_method)
            assert r.last_record()["sort_path"] == "torch"
        assert sorting.sort_words.launches == before
        assert "replay" in methods or cfg.sort_bands > 1, methods


@pytest.mark.parametrize("cfg_kw", [dict(screen_size=256), dict(screen_size=1920,
                                                                screen_height=1088)],
                         ids=["256", "8160-tiles"])
def test_frames_through_the_sort_kernel_equal_the_int64_sort_frames(dev, cfg_kw, monkeypatch):
    """Renderer frames (the kernel's sort, replayed) byte-equal to frames
    made with the stable int64 torch.sort in stage D, at the same poses."""
    from cudagaussianrenderer_torch import render as prender

    scene = pt.random_scene(20_000, seed=3, min_scale=0.002, max_scale=0.053, sh_degree=3,
                            device=dev)
    cfg = pt.RenderConfig(**cfg_kw)
    cams = pt.orbit_cameras(scene.bounds_min, scene.bounds_max, 3, aspect=cfg.aspect)
    r = pt.Renderer(scene, cfg)
    for c in cams:
        r.render(c)
    got = []
    for c in cams * 2:
        got.append((r.render(c), r.last_record()))
    assert [rec["sort_path"] for _, rec in got] == ["kernel"] * len(got)
    assert got[-1][1]["method"] == "replay"
    monkeypatch.setattr(prender, "sort_pairs",
                        lambda pairs, stable=False: sorting._sort_pairs_torch(pairs, stable=True))
    for c, (img, rec) in zip(cams * 2, got):
        want, _ = pt.render_frame(r.scene, c.camera_data(), cfg, rec["key"][0])
        assert np.array_equal(img, want.cpu().numpy())


def test_failed_capture_raises(dev):
    """A frame that waits for the host cannot be captured: the capture
    raises, the renderer keeps no graph and does not fall back to the
    eager frame; capture_frame's own eager check (sync debug mode "error")
    raises on it before any capture.  Last in this file, so that no other
    test runs after a failed capture in the same process."""
    from cudagaussianrenderer_torch.render import capture_frame

    scene = pt.random_scene(500, seed=2, device=dev)
    r = pt.Renderer(scene, pt.RenderConfig(screen_size=128))
    cam = pt.Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    r.render(cam)
    r.render(cam)  # the settled key's first visit
    assert r.last_method == "eager"
    frame = r._frame

    def syncing(key):
        image, counts = frame(key)
        counts.sum().item()  # a host sync: not allowed while capturing
        return image, counts

    r._frame = syncing
    with pytest.raises(RuntimeError):
        r.render(cam)
    assert r._graphs == {}
    with pytest.raises(RuntimeError):
        capture_frame(lambda: syncing(r._key()), dev)


def test_failed_sharded_capture_raises(dev):
    """A rank's frame that waits for the host cannot be captured: in a
    world-size-1 NCCL group the capture raises on the rank, no graph is
    kept, and spawn returns.  Last in this file, beside
    test_failed_capture_raises."""
    from cudagaussianrenderer_torch.parallel import launch

    raised, keys, method = launch.spawn(card_failed_sharded_capture_case, 1, "cuda")[0]
    assert raised and keys == [] and method == "eager"
