"""Every RenderConfig field away from its default, one frame a case: the
port's Renderer on the CPU against the JAX Renderer (Pallas in interpret
mode) on the same SH-1 scene and framed camera, under the suite's image
rule, with the same candidate count and the same capacity after the frame.
A field that changes the picture must change the port's frame against the
same config without it, so that the case holds the field and not the
default.  The cases are split over two test files so that the suite's
workers take them in parallel (a JAX frame compiles for 3-18 s)."""

import numpy as np

import cudagaussianrenderer_torch as pt
import cudagaussianrenderer_tpu as jx

from torch_port_cases import image_close

SQUARE = dict(screen_size=96)
# The selfcheck's scale, and lists deep enough (~113 pairs a tile) for the
# early exit and the capacity to bite.
SHALLOW = dict(n=300)
DEEP = dict(n=1000, min_scale=0.1, max_scale=0.6)
# (name, config, scene, whether the field changes the picture): blending
# and numerics ...
BLEND_CASES = [
    ("transmittance-eps-0.2", dict(SQUARE, transmittance_eps=0.2), DEEP, True),
    # 2 slots a splat: the frame is truncated, in both packages alike.
    ("capacity-factor-2", dict(SQUARE, capacity_factor=2), DEEP, True),
    ("raster-chunk-256", dict(SQUARE, raster_chunk=256), DEEP, True),
    ("epsilon-1e-3", dict(SQUARE, epsilon=1e-3), SHALLOW, True),
    ("gamma-2.2-epanechnikov", dict(SQUARE, gamma=2.2, falloff="epanechnikov"), SHALLOW, True),
]
# ... and layout: bands, tiles, extents, screen shape, sort.
LAYOUT_CASES = [
    ("sort-bands-4-balanced", dict(SQUARE, sort_bands=4, balanced_bands=True), SHALLOW, False),
    ("tile8-sort-bands-2", dict(SQUARE, tile_size=8, sort_bands=2), SHALLOW, False),
    ("extents-flags-off",
     dict(SQUARE, opacity_aware_extents=False, center_sampled_runs=False), SHALLOW, True),
    ("rect-160x96-tile32", dict(screen_size=160, screen_height=96, tile_size=32), SHALLOW, False),
    ("tiles-per-cell-2-stable-sort", dict(SQUARE, tiles_per_cell=2, stable_sort=True), SHALLOW,
     False),
]
# Fields that set the frame's shape: the config a case is compared with
# keeps them.
SHAPE_FIELDS = ("screen_size", "screen_height", "tile_size")


def check_config_frame(name, cfg_kw, scene_kw, shows):
    scene_kw = dict(scene_kw)
    n = scene_kw.pop("n")
    jscene = jx.random_scene(n, seed=2, sh_degree=1, **scene_kw)
    pscene = pt.random_scene(n, seed=2, sh_degree=1, device="cpu", **scene_kw)
    jc, pc = jx.RenderConfig(**cfg_kw), pt.RenderConfig(**cfg_kw)
    cam = jx.Camera(aspect=jc.aspect).framed(jscene.bounds_min, jscene.bounds_max)
    jrend = jx.Renderer(jscene, jc)
    want = jrend.render(cam)
    prend = pt.Renderer(pscene, pc, device="cpu")
    got = prend.render(cam)
    assert got.shape == want.shape == (pc.screen_h, pc.screen_w, 4)
    assert got.dtype == np.uint8 and got[..., 3].max() == 255
    assert prend.last_candidates == jrend.last_candidates
    assert prend.capacity == jrend.capacity
    image_close(got, want, msg=f"{name} vs JAX")
    base = pt.RenderConfig(**{f: v for f, v in cfg_kw.items() if f in SHAPE_FIELDS})
    without = pt.Renderer(pscene, base, device="cpu").render(cam)
    assert (not np.array_equal(got, without)) == shows, f"{name}: the field shows {not shows}"
