"""The integers that cudagaussianrenderer_torch.tools.measure derives from a
scene, exactly against the JAX package's functions on the same seeded
inputs, on the CPU: ``extents``' per-camera candidates and its capacity
(project_splats -> splat_tile_rects -> splat_row_packs, XLA only),
``shardsim``'s and ``shardbal``'s worst band of 2 and 4 devices (the JAX
tool's probes, tools/measure.py:208-225 and :318-340, run here through the
JAX package's functions: the JAX tool itself is not imported), and
``trainscale``'s capacity and k_max (the JAX diff.build_structure, Pallas
in interpret mode, and max_tile_count)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudagaussianrenderer_tpu as jx
from cudagaussianrenderer_torch.tools import measure
from cudagaussianrenderer_tpu import diff as jdiff
from cudagaussianrenderer_tpu.models.camera import orbit_cameras as jx_orbit
from cudagaussianrenderer_tpu.ops.binning import splat_row_packs, splat_tile_rects
from cudagaussianrenderer_tpu.ops.projection import project_splats
from cudagaussianrenderer_tpu.parallel.distributed import _band_bounds, _band_weights
from cudagaussianrenderer_tpu.render import round_capacity as jx_round_capacity

from torch_port_cases import one_torch_thread  # noqa: F401 (an autouse fixture)

N, SIZE = 4096, 256
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def scenes():
    """The bench scene of 4,096 splats in both packages, and its 8 orbit
    cameras."""
    js = jx.random_scene(N, seed=0, min_scale=0.002, max_scale=0.053,
                         extent=4.0).pad_to_multiple(4096)
    ps = measure.bench_scene(N, CPU)
    cams = [c.camera_data() for c in jx_orbit(js.bounds_min, js.bounds_max, 8)]
    return js, ps, cams


def jax_counts(scene, cfg, cam, row_band=None):
    clip = project_splats(scene.means, scene.scales, scene.quats, cam, cfg,
                          opacities=scene.opacities)
    rects = splat_tile_rects(clip, cfg, row_band=row_band)
    return jnp.sum(splat_row_packs(clip, rects, cfg).counts)


def test_extents_counts_and_capacity_match_jax(scenes):
    js, ps, cams = scenes
    got = measure.extents_counts(ps, measure.bench_cameras(ps), SIZE, CPU)
    for key, flag in (("exact", False), ("aware", True)):
        cfg = jx.RenderConfig(screen_size=SIZE, opacity_aware_extents=flag)
        count = jax.jit(lambda c, _cfg=cfg: jax_counts(js, _cfg, c))
        want = [int(count(c)) for c in cams]
        assert got[key] == want, key
    assert got["aware"] != got["exact"]
    assert got["capacity"] == -(-int(max(got["exact"]) * 1.02) // 1024) * 1024


@pytest.mark.parametrize("n_dev", [2, 4])
def test_shardsim_worst_band_matches_the_jax_probe(scenes, n_dev):
    js, ps, cams = scenes
    cfg = jx.RenderConfig(screen_size=SIZE)
    rows = cfg.tiles_y // n_dev
    worst = (0, 0)
    for b in range(n_dev):
        probe = jax.jit(lambda c, _lo=b * rows: jax_counts(js, cfg, c, (_lo, _lo + rows)))
        for c in cams:
            worst = max(worst, (int(probe(c)), b * rows))
    cand, lo = worst
    want = (cand, lo, -(-int(cand * 1.005) // 1024) * 1024)
    got = measure.shardsim_worst(ps, measure.bench_cameras(ps), measure.RenderConfig(
        screen_size=SIZE), n_dev, CPU)
    assert got == want and cand > 0


@pytest.mark.parametrize("n_dev", [2, 4])
def test_shardbal_worst_band_matches_the_jax_probe(scenes, n_dev):
    js, ps, cams = scenes
    cfg = jx.RenderConfig(screen_size=SIZE)
    max_rows = min(cfg.tiles_y, 2 * (cfg.tiles_y // n_dev))

    @jax.jit
    def probe(cam):
        clip = project_splats(js.means, js.scales, js.quats, cam, cfg, opacities=js.opacities)
        bounds = _band_bounds(_band_weights(clip, cfg), n_dev, max_rows)
        return jnp.stack([
            jnp.sum(splat_row_packs(clip, splat_tile_rects(clip, cfg, row_band=(
                bounds[j], bounds[j + 1])), cfg).counts) for j in range(n_dev)])

    worst = (0, 0)
    for c in cams:
        per = np.asarray(probe(c))
        j = int(per.argmax())
        worst = max(worst, (int(per[j]), j))
    cand, band = worst
    want = (cand, band, -(-int(cand * 1.02) // 1024) * 1024)
    got = measure.shardbal_worst(ps, measure.bench_cameras(ps), measure.RenderConfig(
        screen_size=SIZE), n_dev, CPU)
    assert got == want and cand > 0


def test_trainscale_capacity_and_k_max_match_jax():
    n, size = 2000, 64
    got = measure.trainscale_setup(n, size, CPU)
    scene = jx.random_scene(n, seed=3)
    config = jx.RenderConfig(screen_size=size)
    cam = jx_orbit(scene.bounds_min, scene.bounds_max, 1)[0]
    capacity = jx_round_capacity(16 * n)
    structure = jdiff.build_structure(jdiff.from_scene(scene), cam.camera_data(), config,
                                      capacity)
    k_max = max(256, 2 * jdiff.max_tile_count(structure))
    assert (got["capacity"], got["k_max"]) == (capacity, k_max)
    assert got["target"].shape == (size, size, 3) and float(got["target"].max()) > 0
