"""The scenes of tests/test_edge_cases.py (a single splat :21, a one-tile
16-pixel screen :41, one splat larger than the frustum :66, 128 splats on one
depth plane :87) rendered by the port's Renderer on the CPU, each at one
fixed capacity: the JAX test's own assertions; the suite's image rule (at
most 2% of pixels off by more than 8) against the port's golden oracle and
against the JAX Renderer; and with ``stable_sort=True`` within 1 level of
the JAX Renderer's stable frame everywhere (test_torch_edge_cases_ties.py
holds the last two scenes)."""

import numpy as np
import pytest

import cudagaussianrenderer_torch as pt
import cudagaussianrenderer_tpu as jx
from cudagaussianrenderer_torch.golden import golden_render, scene_to_numpy

from torch_port_cases import check_edge_frame, edge_case, image_close, one_torch_thread  # noqa: F401


def renders(name, pkg, stable_sort, **device):
    """Two frames of one Renderer of the package ``pkg``; neither saturated."""
    scene, config, cam = edge_case(name, pkg, stable_sort=stable_sort, **device)
    r = pkg.Renderer(scene, config, **device)
    frames = [np.asarray(r.render(cam)) for _ in range(2)]
    assert not r.saturated and r.last_candidates <= config.capacity
    return frames, scene, config, cam


def check_scene(name):
    got, scene, config, cam = renders(name, pt, False, device="cpu")
    check_edge_frame(name, got[0], got[1])
    golden = golden_render(scene_to_numpy(scene), cam.camera_data(), config)
    image_close(got[0], golden, f"{name} against golden.py")
    want, *_ = renders(name, jx, False)
    check_edge_frame(name, want[0], want[1])
    image_close(got[0], want[0], f"{name} against the JAX Renderer")
    stable, *_ = renders(name, pt, True, device="cpu")
    want_stable, *_ = renders(name, jx, True)
    diff = np.abs(stable[0].astype(np.int32) - want_stable[0].astype(np.int32)).max()
    assert diff <= 1, f"{name}, stable sort: {diff} levels from the JAX frame"


@pytest.mark.parametrize("name", ["single-splat", "one-tile"])
def test_edge_scene_matches_golden_and_jax(name):
    check_scene(name)
