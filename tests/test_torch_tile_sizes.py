"""Tiles larger than 32x32 pixels: every tile size the JAX RenderConfig
accepts renders in the port too, on the CPU through the plain version of
K4, flat and banded, and through DistributedRenderer.

Each frame is held against the JAX ``Renderer`` (Pallas in interpret mode)
and against ``golden.golden_render`` under the suite's image rule (at most
2% of pixels off by more than 8 levels), with the same capacity and
candidate count in both packages; K4's plain version alone against the JAX
raster kernel within its 4 LSB (tests/test_torch_raster.py).  A 30-pixel
edge is no multiple of 4, so the card's kernel blends one pixel a thread
there; a tile of more than 1,024 pixels is a thread-block cluster on the
card, whose launch geometry (ops/raster.py:raster_geometry) is checked here
for every edge."""

import numpy as np
import pytest

import cudagaussianrenderer_torch as pt
import cudagaussianrenderer_tpu as jx
from cudagaussianrenderer_torch import golden as pgold
from cudagaussianrenderer_torch.ops import raster as pr
from cudagaussianrenderer_tpu.ops import raster as jr

from test_torch_raster import T, assert_images_close, sorted_list
from torch_port_cases import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    TILE_SIZE_SPLATS, image_close, one_torch_thread, tile_size_sharded_case,
)

TILE_CASES = [
    ("tile36", dict(screen_size=144, tile_size=36)),
    ("tile48", dict(screen_size=192, tile_size=48)),
    ("tile64", dict(screen_size=256, tile_size=64)),
    ("tile128", dict(screen_size=256, tile_size=128)),
    ("tile64-banded", dict(screen_size=256, tile_size=64, sort_bands=2)),
    ("tile30-60x90", dict(screen_size=60, screen_height=90, tile_size=30)),
]


@pytest.mark.parametrize("name,cfg_kw", TILE_CASES, ids=[c[0] for c in TILE_CASES])
def test_frame_at_tile_size_matches_jax_and_golden(name, cfg_kw):
    jscene = jx.random_scene(TILE_SIZE_SPLATS, seed=2)
    pscene = pt.random_scene(TILE_SIZE_SPLATS, seed=2, device="cpu")
    jc, pc = jx.RenderConfig(**cfg_kw), pt.RenderConfig(**cfg_kw)
    cam = jx.Camera(aspect=jc.aspect).framed(jscene.bounds_min, jscene.bounds_max)
    jrend = jx.Renderer(jscene, jc)
    want = jrend.render(cam)
    prend = pt.Renderer(pscene, pc, device="cpu")
    got = prend.render(cam)
    assert got.shape == want.shape == (pc.screen_h, pc.screen_w, 4)
    assert got[..., 3].max() == 255
    assert prend.last_candidates == jrend.last_candidates
    assert prend.capacity == jrend.capacity
    image_close(got, want, msg=f"{name} vs JAX")
    image_close(got, pgold.golden_render(pgold.scene_to_numpy(pscene), cam.camera_data(), pc),
                msg=f"{name} vs golden")


def test_raster_at_64_pixel_tiles_within_4_lsb():
    """K4's plain version on the JAX package's sorted list of a 256x256
    screen in 64x64 tiles, against the JAX raster kernel (interpret mode)."""
    jc, pc, attrs, starts, counts = sorted_list(dict(screen_size=256, tile_size=64))
    pair_data = jr.pack_pair_data(attrs, jc.raster_chunk)
    want_tiles = jr.rasterize_tiles(pair_data, starts, counts, jc, interpret=True)
    got_tiles = pr.rasterize_tiles(T(pair_data), T(starts), T(counts), pc)
    assert got_tiles.shape == want_tiles.shape == (16, 64 * 64, 4)
    np.testing.assert_array_equal(got_tiles[..., 3].numpy(), np.asarray(want_tiles)[..., 3])
    want = np.asarray(jr.tiles_to_image(want_tiles, jc))
    assert want[..., :3].max() > 0
    assert_images_close(pr.tiles_to_image(got_tiles, pc).numpy(), want)


SHARDED_CASES = [
    ("tile64-balanced", dict(screen_size=256, tile_size=64, balanced_bands=True)),
    ("tile36-uniform", dict(screen_size=144, tile_size=36)),
]


@pytest.mark.parametrize("name,cfg_kw", SHARDED_CASES, ids=[c[0] for c in SHARDED_CASES])
def test_distributed_renderer_at_tile_size(name, cfg_kw):
    """Two gloo ranks, a band of tile rows each: the assembled frame on
    every rank against the port's Renderer by the JAX package's
    multi-device rule (under 0.1% of pixels off by more than 1 level: a
    band's list aligns the early exit's chunks elsewhere)."""
    from cudagaussianrenderer_torch.parallel import launch

    for frames, methods, want in launch.spawn(tile_size_sharded_case, 2, "cpu", cfg_kw, 1):
        assert methods == ["eager"]
        got = frames[0]
        assert got.shape == want.shape and want[..., 3].max() == 255
        off = (np.abs(got.astype(np.int32) - want.astype(np.int32)) > 1).any(axis=-1).mean()
        assert off < 1e-3, f"{name}: {off:.4f} of pixels off by more than 1"


@pytest.mark.parametrize("cap", [pr.PORTABLE_CLUSTER, pr.MAX_CLUSTER])
def test_raster_geometry_covers_every_row_once(cap):
    """K4's launch at every tile edge from 1 to 256 (each divides a legal
    screen: one tile of itself) and at some larger ones: up to 32 one block,
    a thread a group; above, a cluster of 2 to ``cap`` blocks whose bands
    cover every row of the tile once, none empty, in blocks of at most
    1,024 threads taking their groups in equal turns, and in registers (one
    turn) wherever 16-block clusters hold the tile's groups."""
    for ts in [*range(1, 257), 257, 300, 512, 1020, 4080]:
        g = pr.raster_geometry(ts, cap)
        px = 4 if ts % 4 == 0 else 1
        assert g.pixels == px
        groups = g.band_rows * (ts // px)
        if ts <= 32:
            assert g == (px, 1, ts, ts * ts // px)
            continue
        assert 2 <= g.cluster <= cap
        bands = [range(r * g.band_rows, min(ts, (r + 1) * g.band_rows)) for r in range(g.cluster)]
        assert all(len(band) > 0 for band in bands)
        assert [row for band in bands for row in band] == list(range(ts))
        assert 1 <= g.threads <= pr.MAX_THREADS
        turns = -(-groups // g.threads)
        assert (turns - 1) * g.threads < groups <= turns * g.threads
        assert turns == -(-groups // pr.MAX_THREADS)
        if cap == pr.MAX_CLUSTER and ts <= (256 if px == 4 else 128):
            assert turns == 1, ts
