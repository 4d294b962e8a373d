"""Stage F of the PyTorch port against the JAX package on the CPU: the
pair buffer, the plain version of kernel K4 (``rasterize_tiles``) held
against the JAX raster kernel in interpret mode, and ``tiles_to_image``.

The JAX kernel blends a chunk at a time through a log-domain scan of one
bf16 limb, which the JAX package bounds at 4 output levels against an
exact blend; the port multiplies transmittance pair by pair in f32.  Both
stop after the same chunks, so their frames agree within those 4 LSB."""

import functools

import numpy as np
import pytest
import torch

import cudagaussianrenderer_torch as pt
import cudagaussianrenderer_tpu as jx
from cudagaussianrenderer_torch.ops import raster as pr
from cudagaussianrenderer_tpu.ops import raster as jr
from cudagaussianrenderer_tpu.ops.binning import build_tile_pairs
from cudagaussianrenderer_tpu.ops.projection import project_splats as jx_project
from cudagaussianrenderer_tpu.ops.ranges import tile_ranges
from cudagaussianrenderer_tpu.ops.sorting import sort_pairs

LSB_BOUND = 4


def T(a) -> torch.Tensor:
    """A JAX or numpy array as a CPU tensor; uint32 words as int32 bits."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def sorted_list(cfg_kw):
    return _sorted_list(tuple(sorted(cfg_kw.items())))


@functools.lru_cache(maxsize=None)
def _sorted_list(cfg_items, n=400, seed=4, capacity=4096):
    """The JAX package's sorted pair buffer and tile ranges for a scene."""
    cfg_kw = dict(cfg_items)
    scene = jx.random_scene(n, seed=seed).pad_to_multiple(256)
    jc = jx.RenderConfig(**cfg_kw)
    cam = jx.Camera(aspect=jc.aspect).framed(scene.bounds_min, scene.bounds_max)
    clip = jx_project(scene.means, scene.scales, scene.quats, cam.camera_data(), jc,
                      opacities=scene.opacities)
    pairs = build_tile_pairs(clip, scene.colors, scene.opacities, jc, capacity, interpret=True)
    assert int(pairs.num_candidates) <= capacity
    keys, _, attrs = sort_pairs(pairs, stable=True)
    starts, counts = tile_ranges(keys, jc, interpret=True)
    return jc, pt.RenderConfig(**cfg_kw), attrs, starts, counts


CASES = [
    ("gaussian", dict(screen_size=128)),
    ("epanechnikov", dict(screen_size=128, falloff="epanechnikov")),
    ("epanechnikov-background-gamma",
     dict(screen_size=128, falloff="epanechnikov", background=(0.2, 0.5, 0.9), gamma=2.2)),
    ("rect-chunk256-background",
     dict(screen_size=192, screen_height=128, raster_chunk=256, background=(1.0, 1.0, 1.0))),
]


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    return sorted_list(request.param[1])


def assert_images_close(got, want, bound=LSB_BOUND):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= bound, f"max difference {diff.max()} levels"


def test_pack_pair_data_equal(case):
    jc, pc, attrs, starts, counts = case
    want = np.asarray(jr.pack_pair_data(attrs, jc.raster_chunk))
    got = pr.pack_pair_data(tuple(T(a) for a in attrs), pc.raster_chunk)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_raster_within_4_lsb(case):
    jc, pc, attrs, starts, counts = case
    pair_data = jr.pack_pair_data(attrs, jc.raster_chunk)
    want_tiles = jr.rasterize_tiles(pair_data, starts, counts, jc, interpret=True)
    got_tiles = pr.rasterize_tiles(T(pair_data), T(starts), T(counts), pc)
    assert got_tiles.shape == want_tiles.shape == (pc.total_tiles, pc.pixels_per_tile, 4)
    if pc.background is None:
        # Channel 3 is coverage: a yes/no per tile, exact.
        np.testing.assert_array_equal(got_tiles[..., 3].numpy(), np.asarray(want_tiles)[..., 3])
    want = np.asarray(jr.tiles_to_image(want_tiles, jc))
    got = pr.tiles_to_image(got_tiles, pc).numpy()
    assert got.shape == want.shape == (pc.screen_h, pc.screen_w, 4)
    assert want[..., :3].max() > 0  # something rendered
    assert_images_close(got, want)


@pytest.mark.parametrize("bg", [None, (1.0, 1.0, 1.0)], ids=["coverage", "background"])
def test_raster_tile_row_offset(bg):
    """A band of tile rows rendered on its own (num_tiles, tile_row_offset
    > 0) matches the JAX kernel on the same band."""
    jc, pc, attrs, starts, counts = sorted_list(dict(screen_size=128, background=bg))
    lo, rows = 3, 2
    sl = slice(lo * jc.tiles_x, (lo + rows) * jc.tiles_x)
    band_tiles = rows * jc.tiles_x
    pair_data = jr.pack_pair_data(attrs, jc.raster_chunk)
    want_tiles = jr.rasterize_tiles(pair_data, starts[sl], counts[sl], jc,
                                    num_tiles=band_tiles, tile_row_offset=lo, interpret=True)
    got_tiles = pr.rasterize_tiles(T(pair_data), T(starts[sl]), T(counts[sl]), pc,
                                   num_tiles=band_tiles, tile_row_offset=lo)
    want = np.asarray(jr.tiles_to_image(want_tiles, jc))
    got = pr.tiles_to_image(got_tiles, pc).numpy()
    assert got.shape == want.shape == (rows * pc.tile_size, pc.screen_w, 4)
    assert want[..., :3].max() > 0
    assert_images_close(got, want)


@pytest.mark.parametrize(
    "cfg_kw",
    [dict(screen_size=64), dict(screen_size=64, background=(0.25, 0.5, 1.0), gamma=0.45)],
    ids=["plain", "background-gamma"],
)
def test_tiles_to_image_matches(cfg_kw):
    jc, pc = jx.RenderConfig(**cfg_kw), pt.RenderConfig(**cfg_kw)
    rng = np.random.default_rng(0)
    tiles = rng.uniform(-0.1, 1.1, (jc.total_tiles, jc.pixels_per_tile, 4)).astype(np.float32)
    want = np.asarray(jr.tiles_to_image(tiles, jc))
    got = pr.tiles_to_image(torch.from_numpy(tiles), pc).numpy()
    # One level at most: an f32 pow and an f32 product may round to either
    # side of a level boundary in XLA and in PyTorch.
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    if "gamma" not in cfg_kw:
        np.testing.assert_array_equal(got, want)


def test_raster_stats_count_blended_pairs():
    """K4's counter from the plain version, on the JAX package's list: the
    count the stats dict it replaces gave (every pair, no tile exits)."""
    jc, pc, attrs, starts, counts = sorted_list(dict(screen_size=128))
    pair_data = T(jr.pack_pair_data(attrs, jc.raster_chunk))
    blended = torch.zeros(1, dtype=torch.int32)
    pr._raster_torch(pair_data, T(starts), T(counts), pc, pc.total_tiles, 0, blended)
    # The early exit can only cut the pairs blended.
    assert 0 < int(blended) <= int(np.asarray(counts).sum())
    assert int(blended) == 1657
