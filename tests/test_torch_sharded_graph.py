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
"""

import functools

import numpy as np
import pytest
import torch

import cudagaussianrenderer_torch as pt
import cudagaussianrenderer_tpu as jx
from cudagaussianrenderer_torch.ops import binning, raster
from cudagaussianrenderer_torch.ops.projection import project_splats
from cudagaussianrenderer_torch.parallel import distributed as pd
from cudagaussianrenderer_torch.parallel import launch
from cudagaussianrenderer_torch.render import _frame_pairs, _splat_colors, camera_tensors
from cudagaussianrenderer_tpu.parallel import distributed as jd

import torch_port_cases as cases
from torch_port_cases import (  # noqa: F401
    GRAPH_SEED, GRAPH_SIZE, GRAPH_SPLATS, REVISITS, SHARDED_KEY_CASES, one_torch_thread,
)

CONFIGS = [dict(screen_size=GRAPH_SIZE, balanced_bands=True),
           dict(screen_size=GRAPH_SIZE, balanced_bands=True, background=(0.2, 0.4, 0.6))]


def band_inputs(cfg):
    scene = cases.graph_scene()
    cam = camera_tensors(pt.Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
                         .camera_data(), "cpu")
    clip = project_splats(scene.means, scene.scales, scene.quats, cam, cfg,
                          opacities=scene.opacities)
    return clip, _splat_colors(scene, cam), scene.opacities


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


@pytest.fixture(scope="module", params=[2, 4], ids=["2-ranks", "4-ranks"])
def group(request):
    n = request.param
    return n, launch.spawn(cases.sharded_graph_cases, n, "cpu", n)


def on_every_rank(ranks, key):
    def eq(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(eq(a[k], b[k]) for k in a)
        if isinstance(a, np.ndarray):
            return a.dtype == b.dtype and np.array_equal(a, b)
        return a == b

    assert all(eq(r[key], ranks[0][key]) for r in ranks[1:]), f"{key} differs between ranks"
    return ranks[0][key]


@functools.lru_cache(maxsize=None)
def jax_key_sequence(n, balanced, adaptive, start):
    """The JAX DistributedRenderer of the same scene, config and start on an
    n-device mesh: its key (``_get_fn``'s capacity) and capacity a frame."""
    scene = jx.random_scene(GRAPH_SPLATS, seed=GRAPH_SEED, sh_degree=3)
    cfg = jx.RenderConfig(screen_size=GRAPH_SIZE, balanced_bands=balanced,
                          capacity=None if adaptive else start)
    r = jd.DistributedRenderer(scene, cfg, mesh=jd.make_mesh(n))
    r.capacity = start
    keys, after, get_fn = [], [], r._get_fn

    def counted(batched):
        keys.append((r.capacity, batched))
        return get_fn(batched)

    r._get_fn = counted
    for cam in jx.orbit_cameras(scene.bounds_min, scene.bounds_max, 6):
        r.render(cam)
        after.append(r.capacity)
    assert set(keys) == set(r._fns)
    return [k for k, _ in keys], after


def test_capacity_keys_follow_the_jax_renderer(group):
    """(c) The key each frame ran at and the capacity after it, frame by
    frame, against the JAX DistributedRenderer; every rank the same."""
    n, ranks = group
    seqs = on_every_rank(ranks, "keys")
    assert set(seqs) == {c[0] for c in SHARDED_KEY_CASES if c[1] == n}
    for name, ranks_n, balanced, adaptive, start in SHARDED_KEY_CASES:
        if ranks_n != n:
            continue
        keys, after = seqs[name]
        want_keys, want_after = jax_key_sequence(n, balanced, adaptive, start)
        assert keys == want_keys, name
        assert after == want_after, name
        assert len(set(keys)) == 2 and keys[0] == start  # the case walks keys


@pytest.mark.parametrize("mesh,balanced", [("1d", False), ("1d", True), ("2d", False)],
                         ids=["1d-uniform", "1d-balanced", "2d"])
def test_renderer_frames_equal_tilesharded_frames(group, mesh, balanced):
    """(d) Cameras visited in the order REVISITS: every ``render`` frame and
    every ``render_batch`` frame (4 cameras; on the 2-D mesh, 2x1 on two
    ranks and 2x2 on four, two a frame group) equals
    render_frames_tilesharded's frame of its camera at the same capacity,
    byte for byte, on every rank.  The static camera ends holding the last
    camera of the rank's share of the batch."""
    n, ranks = group
    scene = cases.graph_scene()
    cams = pt.orbit_cameras(scene.bounds_min, scene.bounds_max, 3)
    tiles = n if mesh == "1d" else n // 2
    for rank, result in enumerate(ranks):
        got = result[(mesh, balanced)]
        want = got["want"]
        assert want.shape == (len(REVISITS), GRAPH_SIZE, GRAPH_SIZE, 4)
        assert want[..., 3].max() == 255
        np.testing.assert_array_equal(got["render"], want, err_msg=f"rank {rank}")
        np.testing.assert_array_equal(got["batch"], want[:4], err_msg=f"rank {rank}")
        np.testing.assert_array_equal(got["want"], ranks[0][(mesh, balanced)]["want"])
        cap, after = got["capacity"]
        assert cap == after
        last = 3 if mesh == "1d" else 2 * (rank // tiles) + 1
        np.testing.assert_array_equal(
            got["camera"], pt.render.camera_array(cams[REVISITS[last]].camera_data()))
