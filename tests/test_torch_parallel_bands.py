"""The port's balanced bands (cudagaussianrenderer_torch.parallel.distributed)
against the JAX package's, on the CPU, with no process group: the band
weights and boundaries exactly, and ``render_band`` for every band of two
and four ranks against the jitted JAX ``render_band`` (Pallas in
interpret mode).

The two raster kernels blend by different arithmetic (the JAX kernel's
log-domain scan of one bf16 limb, the port's pair-by-pair f32 product;
tests/test_torch_raster.py bounds them at 4 output levels), so a band's
colours are held within those 4 levels; its bounds, pair counts, coverage
channel and the zero rows outside the band are exact."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudagaussianrenderer_torch as pt
import cudagaussianrenderer_tpu as jx
from cudagaussianrenderer_torch import golden as pgold
from cudagaussianrenderer_torch.ops.projection import SplatClipData
from cudagaussianrenderer_torch.parallel import distributed as pd
from cudagaussianrenderer_tpu.ops.projection import project_splats as jx_project
from cudagaussianrenderer_tpu.parallel import distributed as jd

from torch_port_cases import PAR_SHARD_CAP, PAR_SIZE, image_close, one_torch_thread  # noqa: F401

# K4 against the JAX raster kernel (tests/test_torch_raster.py).
LSB_BOUND = 4


def jax_skewed_scene(n_dev):
    """tests/test_distributed.py's skewed scene, built by the JAX package."""
    scene = jx.random_scene(512 * n_dev, seed=7).pad_to_multiple(256 * n_dev)
    m = np.array(scene.means)
    m[1] = m[1].max() - (m[1] - m[1].min()) * 0.15
    return dataclasses.replace(scene, means=jnp.asarray(m))


def to_port(jscene):
    arrays = {f: getattr(jscene, f) for f in ("means", "scales", "quats", "opacities", "colors",
                                              "sh", "sh_degree", "count", "bounds_min",
                                              "bounds_max")}
    arrays = {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in arrays.items()}
    return pt.scene_from_numpy(arrays, device="cpu")


def jax_clip(jscene, cfg_kw):
    jc = jx.RenderConfig(**cfg_kw)
    cam = jx.Camera(aspect=jc.aspect).framed(jscene.bounds_min, jscene.bounds_max)
    return jc, jx_project(jscene.means, jscene.scales, jscene.quats, cam.camera_data(), jc,
                          opacities=jscene.opacities)


WEIGHT_CASES = [
    ("skewed-128", 2, dict(screen_size=128), 1 << 16),
    ("skewed-256-subsampled", 4, dict(screen_size=256), 300),
    ("rect-192x128-subsampled", 2, dict(screen_size=192, screen_height=128), 97),
]


@pytest.mark.parametrize("name,n_dev,cfg_kw,cap", WEIGHT_CASES, ids=[c[0] for c in WEIGHT_CASES])
def test_band_weights_match_jax(name, n_dev, cfg_kw, cap):
    """The same clip data (the JAX package's) gives the same f32 row
    weights, also when the splats are subsampled."""
    jc, jclip = jax_clip(jax_skewed_scene(n_dev), cfg_kw)
    want = np.asarray(jd._band_weights(jclip, jc, sample_cap=cap))
    clip = SplatClipData(*[torch.from_numpy(np.array(f)) for f in jclip])
    got = pd._band_weights(clip, pt.RenderConfig(**cfg_kw), sample_cap=cap)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


def _skewed(seed, ty):
    return (np.random.default_rng(seed).exponential(1.0, ty) ** 3).astype(np.float32)


BOUND_CASES = [
    # tests/test_distributed.py:292-314: skewed exponential weights.
    ("skewed-0", _skewed(0, 64), 4, 32),
    ("skewed-1", _skewed(1, 64), 8, 16),
    ("skewed-2", _skewed(2, 64), 2, 64),
    ("all-zero", np.zeros(8, np.float32), 4, 4),
    # Integer weights: exact sums, so targets land on cdf values and the
    # snap rule's ties decide.
    ("integers", np.random.default_rng(3).integers(0, 9, 64).astype(np.float32), 4, 32),
    ("ones-tie", np.ones(8, np.float32), 4, 4),
    ("integers-clamped", np.random.default_rng(4).integers(0, 300, 40).astype(np.float32), 5, 9),
    ("one-hot-row", np.eye(1, 16, 5, dtype=np.float32)[0] * 1000, 4, 8),
]


@pytest.mark.parametrize("name,w,n_dev,max_rows", BOUND_CASES, ids=[c[0] for c in BOUND_CASES])
def test_band_bounds_match_jax(name, w, n_dev, max_rows):
    want = np.asarray(jd._band_bounds(jnp.asarray(w), n_dev, max_rows))
    got = pd._band_bounds(torch.from_numpy(w), n_dev, max_rows)
    assert got.dtype == torch.int32 and got.shape == (n_dev + 1,)
    np.testing.assert_array_equal(got.numpy(), want)
    sizes = np.diff(want)
    assert want[0] == 0 and want[-1] == w.shape[0] and (sizes >= 1).all()


@functools.lru_cache(maxsize=None)
def jax_bands(n_dev):
    """Every band of the JAX render_band on the skewed scene: (frames,
    aux), one jitted program for all bands."""
    jscene = jax_skewed_scene(n_dev)
    jc = jx.RenderConfig(screen_size=PAR_SIZE, balanced_bands=True)
    cam = jx.Camera(aspect=1.0).framed(jscene.bounds_min, jscene.bounds_max)
    fn = jax.jit(jd.render_band, static_argnums=(2, 3, 4))
    out = []
    for d in range(n_dev):
        full, aux = fn(jscene, cam.camera_data(), jc, PAR_SHARD_CAP, n_dev, d)
        out.append((np.asarray(full), {k: int(np.asarray(v)) for k, v in aux.items()}))
    return jscene, cam, out


@pytest.mark.parametrize("n_dev", [2, 4])
def test_render_band_matches_jax(n_dev):
    """Every band: the same bounds and pair counts, the same zero rows
    outside the band and coverage channel, colours within 4 levels."""
    jscene, cam, want = jax_bands(n_dev)
    scene = to_port(jscene)
    cfg = pt.RenderConfig(screen_size=PAR_SIZE, balanced_bands=True)
    ts = cfg.tile_size
    lo_prev = 0
    for d, (wframe, waux) in enumerate(want):
        frame, aux = pd.render_band(scene, cam.camera_data(), cfg, PAR_SHARD_CAP, n_dev, d,
                                    device="cpu")
        frame = frame.numpy()
        assert (aux["band_lo"], aux["band_hi"]) == (waux["band_lo"], waux["band_hi"])
        assert aux["band_lo"] == lo_prev < aux["band_hi"]
        lo_prev = aux["band_hi"]
        assert int(aux["num_candidates"]) == waux["num_candidates"]
        assert int(aux["num_pairs"]) == waux["num_pairs"]
        assert frame.shape == wframe.shape == (PAR_SIZE, PAR_SIZE, 4)
        outside = np.ones(PAR_SIZE, bool)
        outside[aux["band_lo"] * ts:aux["band_hi"] * ts] = False
        assert not frame[outside].any() and not wframe[outside].any()
        np.testing.assert_array_equal(frame[..., 3], wframe[..., 3])
        diff = np.abs(frame.astype(np.int32) - wframe.astype(np.int32))
        assert diff.max() <= LSB_BOUND, f"band {d}: max difference {diff.max()} levels"
        assert frame[~outside, :, :3].any()
    assert lo_prev == cfg.tiles_y


def test_render_band_selfcheck_case_against_golden():
    """tools/tpu_selfcheck.py's balanced-bands case on the port: two bands
    of a 128x128 frame of 500 splats (seed 2), summed, against golden.py."""
    cfg = pt.RenderConfig(screen_size=128)
    scene = pt.random_scene(500, seed=2, device="cpu").pad_to_multiple(256)
    cam = pt.Camera(aspect=cfg.aspect).framed(scene.bounds_min, scene.bounds_max)
    total = np.zeros((cfg.screen_h, cfg.screen_w, 4), np.int32)
    for d in range(2):
        full, _ = pd.render_band(scene, cam.camera_data(), cfg, 16384, 2, d, device="cpu")
        total += full.numpy().astype(np.int32)
    assert total.max() <= 255
    want = pgold.golden_render(pgold.scene_to_numpy(scene), cam.camera_data(), cfg)
    image_close(total.astype(np.uint8), want, "balanced bands 2-dev 128px vs golden")


def test_render_band_one_band_is_the_frame():
    """One band covers every row: render_band(n_dev=1) is render_frame."""
    cfg = pt.RenderConfig(screen_size=64, stable_sort=True)
    scene = pt.random_scene(300, seed=4, device="cpu").pad_to_multiple(256)
    cam = pt.Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max).camera_data()
    full, aux = pd.render_band(scene, cam, cfg, 8192, 1, 0, device="cpu")
    want, waux = pt.render_frame(scene, cam, cfg, 8192, device="cpu")
    assert torch.equal(full, want)
    assert (aux["band_lo"], aux["band_hi"]) == (0, cfg.tiles_y)
    assert int(aux["num_pairs"]) == int(waux["num_pairs"])


class _Line:
    """A mesh's shape alone: what _validate reads."""

    def __init__(self, n):
        self.shape = {"tiles": n}


@pytest.mark.parametrize("cfg_kw,n,scene_n,match", [
    (dict(screen_size=128, sort_bands=4), 2, 512, "sort_bands"),
    (dict(screen_size=128), 3, 768, "tiles_y"),
    (dict(screen_size=128, tiles_per_cell=64), 2, 512, "tiles_per_cell"),
    (dict(screen_size=128), 2, 301, "pad the scene"),
], ids=["banded", "rows", "cells", "splats"])
def test_sharded_configurations_refused_as_in_jax(cfg_kw, n, scene_n, match):
    """The port refuses what the JAX package's _validate refuses, with the
    same reasons."""
    scene = pt.random_scene(scene_n, seed=1, device="cpu")
    with pytest.raises(ValueError, match=match):
        pd._validate(pt.RenderConfig(**cfg_kw), _Line(n), "tiles", scene)
    jscene = jx.random_scene(scene_n, seed=1)
    with pytest.raises(ValueError, match=match):
        jd._validate(jx.RenderConfig(**cfg_kw), _Line(n), "tiles", jscene)
