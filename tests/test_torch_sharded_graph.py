"""The port's sharded frame as the JAX DistributedRenderer's compiled frame,
on the CPU.

On the card a rank's frame (parallel.distributed._render_shard) takes its
balanced band bounds and K4's row offset from device memory and replays
one CUDA graph a capacity key.  There is no capture on the CPU, but the
CPU runs the same code over the same tensors, so these tests hold:

- (a) the binning, the band's image and its placement with the band as
  0-d int32 tensors equal, bit for bit, to the same with the band as ints,
  for every band of 2, 4 and 8 balanced bands, and the placement to the
  rows of the band as slicing puts them;
- (b) K4's plain version with a tensor row offset equal, bit for bit, to
  the int one;
- (c) the capacity after each frame and the key each frame ran at of a
  DistributedRenderer on gloo groups of 2 and 4 ranks equal to the JAX
  DistributedRenderer's ``capacity`` and ``_fns`` keys (without
  ``batched``) frame by frame over 6 orbit cameras, on the suite's virtual
  CPU devices, adaptive and fixed;
- (d) ``render`` and ``render_batch`` over the refilled static camera
  equal, byte for byte, to render_frames_tilesharded of the same cameras
  at the same capacity, cameras revisited, on 1-D meshes of 2 and 4 ranks
  and 2-D meshes of two frame groups (2x1 and 2x2).

Every comparison is exact: tolerance 0.  128x128, 350 splats, SH degree 3.
(c) and (d) run here on 2 ranks and in test_torch_sharded_graph_4ranks.py
on 4 (their checks: sharded_graph_checks.py).
"""

import pytest
import torch

import cudagaussianrenderer_torch as pt
from cudagaussianrenderer_torch.ops import binning, raster
from cudagaussianrenderer_torch.ops.projection import project_splats
from cudagaussianrenderer_torch.parallel import distributed as pd
from cudagaussianrenderer_torch.ops.splat import splat_colors
from cudagaussianrenderer_torch.render import _frame_pairs, camera_tensors

import sharded_graph_checks as checks
import torch_port_cases as cases
from torch_port_cases import GRAPH_SIZE, one_torch_thread  # noqa: F401

CONFIGS = [dict(screen_size=GRAPH_SIZE, balanced_bands=True),
           dict(screen_size=GRAPH_SIZE, balanced_bands=True, background=(0.2, 0.4, 0.6))]


def band_inputs(cfg):
    scene = cases.graph_scene()
    cam = camera_tensors(pt.Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
                         .camera_data(), "cpu")
    clip = project_splats(scene.means, scene.scales, scene.quats, cam, cfg,
                          opacities=scene.opacities)
    return clip, splat_colors(scene, cam), scene.opacities


def same(a, b):
    """Tensors, tuples of them and NamedTuples of them, bit for bit."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("cfg_kw", CONFIGS, ids=["coverage", "background"])
@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_device_band_equals_int_band(n_dev, cfg_kw):
    """(a) Every band of ``n_dev`` balanced bands: the rects, the pair list,
    the band's image and its placed frame from 0-d tensor bounds equal
    those from the same bounds as ints; the placed frame holds the image's
    first (hi - lo) tile rows at row lo and zeros elsewhere."""
    cfg = pt.RenderConfig(**cfg_kw)
    clip, colors, opacities = band_inputs(cfg)
    max_rows = pd._balanced_rows(cfg, n_dev)
    bounds = pd._band_bounds(pd._band_weights(clip, cfg), n_dev, max_rows)
    ts = cfg.tile_size
    for d in range(n_dev):
        lo_t, hi_t = bounds[d], bounds[d + 1]
        lo, hi = int(lo_t), int(hi_t)
        assert lo_t.dim() == 0 and lo_t.dtype == torch.int32 and lo < hi
        assert same(binning.splat_tile_rects(clip, cfg, row_band=(lo_t, hi_t)),
                    binning.splat_tile_rects(clip, cfg, row_band=(lo, hi)))
        assert same(binning.build_tile_pairs(clip, colors, opacities, cfg, 8192,
                                             row_band=(lo_t, hi_t)),
                    binning.build_tile_pairs(clip, colors, opacities, cfg, 8192,
                                             row_band=(lo, hi)))
        img_t, pairs_t = pd._band_image(clip, colors, opacities, cfg, 8192, lo_t, hi_t, max_rows)
        img, pairs = pd._band_image(clip, colors, opacities, cfg, 8192, lo, hi, max_rows)
        assert same(img_t, img) and same(pairs_t, pairs)
        assert img.shape == (max_rows * ts, cfg.screen_w, 4) and img[..., 3].max() == 255
        placed = pd._place_band(img_t, lo_t, hi_t, cfg)
        assert same(placed, pd._place_band(img, lo, hi, cfg))
        want = torch.zeros_like(placed)
        want[lo * ts:hi * ts] = img[:(hi - lo) * ts]
        assert same(placed, want)


def test_raster_tensor_row_offset_equals_int():
    """(b) K4's plain version and its wrapper on a CPU tensor, over tile
    rows 3-5 with a background, the offset as an int and as a 0-d int32
    tensor."""
    cfg = pt.RenderConfig(screen_size=GRAPH_SIZE, background=(0.2, 0.4, 0.6))
    scene = cases.graph_scene()
    cam = pt.Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    _, attrs, starts, counts = _frame_pairs(scene, camera_tensors(cam.camera_data(), "cpu"),
                                            cfg, 8192)
    sl = slice(3 * cfg.tiles_x, 6 * cfg.tiles_x)
    args = (raster.pack_pair_data(attrs, cfg.raster_chunk), starts[sl].contiguous(),
            counts[sl].contiguous(), cfg)
    offset = torch.tensor(3, dtype=torch.int32)
    want = raster._raster_torch(*args, 3 * cfg.tiles_x, 3)
    assert same(raster._raster_torch(*args, 3 * cfg.tiles_x, offset), want)
    assert same(raster.rasterize_tiles(*args, num_tiles=3 * cfg.tiles_x, tile_row_offset=offset),
                want)
    assert int(counts[sl].sum()) > 0


@pytest.fixture(scope="module", params=[2], ids=["2-ranks"])
def group(request):
    return checks.spawn_group(request.param)


def test_capacity_keys_follow_the_jax_renderer(group):
    """(c) The key each frame ran at and the capacity after it, frame by
    frame, against the JAX DistributedRenderer; every rank the same."""
    checks.capacity_keys_follow_the_jax_renderer(group)


@pytest.mark.parametrize("mesh,balanced", [("1d", False), ("1d", True), ("2d", False)],
                         ids=["1d-uniform", "1d-balanced", "2d"])
def test_renderer_frames_equal_tilesharded_frames(group, mesh, balanced):
    """(d) Cameras visited in the order REVISITS: every ``render`` and
    ``render_batch`` frame equals render_frames_tilesharded's frame of its
    camera at the same capacity, byte for byte, on every rank."""
    checks.renderer_frames_equal_tilesharded_frames(group, mesh, balanced)
