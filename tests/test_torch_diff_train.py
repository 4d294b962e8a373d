"""The counterparts of tests/test_diff.py's training tests on the port
alone, at their scale: loss reduction with Adam and with the 3DGS optimizer,
densification, and pose and exposure refinement with the splats frozen.
tests/test_torch_diff_fit.py holds the fit against the JAX package's."""

import numpy as np
import pytest
import torch

from cudagaussianrenderer_torch import diff
from cudagaussianrenderer_torch.config import RenderConfig
from cudagaussianrenderer_torch.models.camera import Camera, orbit_cameras
from cudagaussianrenderer_torch.models.scene import random_scene
from cudagaussianrenderer_torch.render import Renderer

from torch_port_cases import one_torch_thread, rendered_views  # noqa: F401 (one_torch_thread: an autouse fixture)

CPU = "cpu"


def _recovery_setup():
    """test_diff.py's recovery point: a 60-splat scene, its render_diff frame
    as the target, and a perturbed start."""
    scene = random_scene(60, seed=4, min_scale=0.1, max_scale=0.4, device=CPU)
    config = RenderConfig(screen_size=64)
    cam_data = Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max).camera_data()
    truth = diff.from_scene(scene)
    structure = diff.build_structure(truth, cam_data, config, 8192, device=CPU)
    k_max = max(8, diff.max_tile_count(structure))
    target, _ = diff.render_diff(truth, cam_data, config, 8192, k_max, structure=structure,
                                 device=CPU)
    rng = np.random.default_rng(0)
    noisy = truth._replace(
        means=truth.means + torch.from_numpy(
            rng.normal(scale=0.15, size=tuple(truth.means.shape)).astype(np.float32)),
        colors=torch.from_numpy(rng.uniform(0.2, 0.8, tuple(truth.colors.shape))
                                .astype(np.float32)),
    )
    return scene, config, cam_data, target[..., :3].numpy(), noisy, k_max


def test_fit_reduces_loss():
    scene, config, cam_data, target, noisy, k_max = _recovery_setup()
    _, losses = diff.fit(noisy, [cam_data], [target], config, capacity=8192,
                         k_max=max(k_max, 64), steps=60, learning_rate=1e-2, device=CPU)
    assert losses[-1] < 0.4 * losses[0], (losses[0], losses[-1])
    assert np.isfinite(losses).all()


def test_fit_3dgs_optimizer_reduces_loss():
    scene, config, cam_data, target, noisy, k_max = _recovery_setup()
    extent = float(np.linalg.norm(np.subtract(scene.bounds_max, scene.bounds_min)))
    _, losses = diff.fit(noisy, [cam_data], [target], config, capacity=8192,
                         k_max=max(k_max, 64), steps=60, tx=diff.tx_3dgs(extent, 60),
                         l1_weight=0.8, ssim_weight=0.2, l2_weight=0.0, device=CPU)
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])
    assert np.isfinite(losses).all()


def test_fit_with_densification_grows_and_converges():
    scene = random_scene(80, seed=4, min_scale=0.1, max_scale=0.4, device=CPU)
    config = RenderConfig(screen_size=64)
    cam_data = Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max).camera_data()
    truth = diff.from_scene(scene)
    structure = diff.build_structure(truth, cam_data, config, 8192, device=CPU)
    k_max = max(8, diff.max_tile_count(structure))
    target, _ = diff.render_diff(truth, cam_data, config, 8192, k_max, structure=structure,
                                 device=CPU)
    start = diff.random_init(20, scene.bounds_min, scene.bounds_max, seed=1, scale=0.3,
                             device=CPU)
    fitted, losses = diff.fit(start, [cam_data], [target[..., :3].numpy()], config,
                              capacity=8192, k_max=max(k_max, 128), steps=40,
                              learning_rate=1e-2, densify_every=10,
                              densify_args=dict(grad_threshold=1e-5, dense_scale=0.05),
                              device=CPU)
    assert fitted.means.shape[-1] > 20
    assert losses[-1] < 0.7 * losses[0]
    assert np.isfinite(losses).all()


class _Frozen:
    """optax.sgd(0.0): the splats stay where they are."""

    def init(self, params):
        return ()

    def update(self, grads, state, params=None):
        return diff.tree_map(torch.zeros_like, grads), state


def test_pose_refinement_recovers_perturbed_camera():
    """Targets from the true cameras; the fit sees perturbed poses with the
    true splats frozen: pose deltas must recover most of the loss."""
    scene, true_cams, targets = rendered_views(60, 9, 32, 2)
    extent = float(np.linalg.norm(np.subtract(scene.bounds_max, scene.bounds_min)))
    rng = np.random.default_rng(3)
    perturbed = [diff.refined_camera(c, 0.03 * rng.standard_normal(3),
                                     0.02 * extent * rng.standard_normal(3)) for c in true_cams]
    cam_data = [c.camera_data() for c in perturbed]

    def run(**kw):
        return diff.fit(diff.from_scene(scene), cam_data, targets, RenderConfig(screen_size=32),
                        capacity=4096, k_max=256, steps=40, tx=_Frozen(), l2_weight=1.0,
                        device=CPU, **kw)

    _, losses_fixed = run()
    _, losses_posed, deltas = run(optimize_cameras=True, camera_lr=3e-3)
    assert losses_posed[0] == pytest.approx(losses_fixed[0], rel=1e-5)
    assert losses_posed[-1] < 0.5 * losses_fixed[-1]
    assert torch.isfinite(deltas.dr).all() and float(deltas.dr.abs().max()) < 0.2


def test_exposure_refinement_recovers_per_view_gain():
    """Targets with per-view exposure shifts: the learned gains follow them,
    with the splats frozen."""
    scene = random_scene(60, seed=12, device=CPU)
    renderer = Renderer(scene, RenderConfig(screen_size=32), device=CPU)
    cams = orbit_cameras(scene.bounds_min, scene.bounds_max, 2)
    shifts = np.array([[1.25] * 3, [0.8] * 3], np.float32)
    targets = [np.clip(renderer.render(c)[..., :3].astype(np.float32) / 255.0 * shifts[i], 0, 1)
               for i, c in enumerate(cams)]

    def run(**kw):
        return diff.fit(diff.from_scene(scene), [c.camera_data() for c in cams], targets,
                        RenderConfig(screen_size=32), capacity=4096, k_max=256, steps=30,
                        tx=_Frozen(), l2_weight=1.0, device=CPU, **kw)

    _, losses_fixed = run()
    _, losses_exp, exp = run(optimize_exposure=True, exposure_lr=3e-2)
    assert losses_exp[-1] < 0.5 * losses_fixed[-1]
    g = exp.gain.numpy()
    assert g[0].mean() > 1.05 and g[1].mean() < 0.95
