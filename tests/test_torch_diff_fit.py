"""The port's fit: the 3DGS recipe (tx_3dgs, L1 + D-SSIM, one densify step)
against the JAX package's on the same targets, then the counterparts of
tests/test_diff.py's capacity warning, depth-supervised fit and SH warm-up
tests on the port alone (tests/test_torch_diff_train.py has the rest).

Targets come from the port's Renderer or render_diff, so both packages fit
the same arrays.  Losses agree within LOSS_RTOL and the fitted parameters
within PARAM_ATOL (the same f32 arithmetic; rounding differences grow a
little each step); the densify step makes the same splats."""

import numpy as np
import pytest
import torch

from cudagaussianrenderer_torch import diff
from cudagaussianrenderer_torch.config import RenderConfig
from cudagaussianrenderer_torch.models.camera import Camera
from cudagaussianrenderer_torch.models.scene import random_scene
from cudagaussianrenderer_tpu import diff as jdiff
from cudagaussianrenderer_tpu.config import RenderConfig as JRenderConfig

from torch_port_cases import one_torch_thread, rendered_views  # noqa: F401 (one_torch_thread: an autouse fixture)

LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-4
CPU = "cpu"


def test_fit_3dgs_with_densify_tracks_jax():
    """tx_3dgs with the paper's loss (L1 0.8, D-SSIM 0.2) and a densify step
    after step 2: the same losses, splat count and fitted splats as the JAX
    package."""
    scene, cams, targets = rendered_views(40, 4, 32, 2, sh_degree=1)
    cam_data = [c.camera_data() for c in cams]
    kw = dict(capacity=4096, k_max=128, steps=5, l1_weight=0.8, ssim_weight=0.2, l2_weight=0.0,
              densify_every=2, densify_args=dict(grad_threshold=2e-4, dense_scale=0.1))
    extent = float(np.linalg.norm(np.subtract(scene.bounds_max, scene.bounds_min)))
    # Anisotropic splats: an isotropic splat's rotation has no gradient but
    # rounding noise, which tx_3dgs's eps of 1e-15 turns into steps of its
    # full rate, in either direction, in either package.
    stretch = np.random.default_rng(0).normal(0, 0.4, (3, 30)).astype(np.float32)
    jinit = jdiff.random_init(30, scene.bounds_min, scene.bounds_max, seed=2, scale=0.3,
                              sh_degree=1)
    jinit = jinit._replace(log_scales=jinit.log_scales + stretch)
    want_p, want_l = jdiff.fit(jinit, cam_data, targets, JRenderConfig(screen_size=32),
                               tx=jdiff.tx_3dgs(extent, 5), **kw)
    pinit = diff.random_init(30, scene.bounds_min, scene.bounds_max, seed=2, scale=0.3,
                             sh_degree=1, device=CPU)
    pinit = pinit._replace(log_scales=pinit.log_scales + torch.from_numpy(stretch))
    got_p, got_l = diff.fit(pinit, cam_data, targets, RenderConfig(screen_size=32),
                            tx=diff.tx_3dgs(extent, 5), device=CPU, **kw)
    assert got_p.means.shape[-1] == want_p.means.shape[-1] != 30
    np.testing.assert_allclose(got_l, want_l, rtol=LOSS_RTOL)
    for name, g, w in zip(got_p._fields, got_p, want_p):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=PARAM_ATOL,
                                   err_msg=name)


def test_fit_warns_on_capacity_saturation():
    scene = random_scene(200, seed=2, device=CPU)
    cam_data = Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max).camera_data()
    with pytest.warns(RuntimeWarning, match="candidate pairs exceed"):
        diff.fit(diff.from_scene(scene), [cam_data], [np.zeros((64, 64, 3), np.float32)],
                 RenderConfig(screen_size=64), capacity=128, k_max=32, steps=2,
                 learning_rate=1e-3, device=CPU)


def test_depth_supervised_fit_moves_depth():
    """A depth-only loss pulls a splat's depth toward the target."""
    def make(zoff):
        return diff.DiffSplats(
            means=torch.tensor([[0.0], [0.0], [zoff]]),
            log_scales=torch.zeros((3, 1)),
            quats=torch.tensor([[0.0], [0.0], [0.0], [1.0]]),
            opacity_logits=torch.full((1,), 2.0),
            colors=torch.full((3, 1), 0.5),
        )

    config = RenderConfig(screen_size=32)
    cd = Camera(position=np.array([0, 0, 5], np.float32)).camera_data()
    _, dtarget, _ = diff.render_diff(make(0.0), cd, config, 512, 32, return_depth=True,
                                     device=CPU)

    def depth_err(p):
        _, d, _ = diff.render_diff(p, cd, config, 512, 32, return_depth=True, device=CPU)
        return float((d - dtarget).abs().mean())

    p0 = make(0.5)
    target_img = np.zeros((32, 32, 3), np.float32)
    fitted, losses = diff.fit(p0, [cd], [target_img], config, capacity=512, k_max=32, steps=40,
                              learning_rate=2e-2, l2_weight=0.0, depth_weight=1.0,
                              depth_targets=[dtarget], device=CPU)
    assert depth_err(fitted) < 0.3 * depth_err(p0)
    assert losses[-1] < losses[0]
    with pytest.raises(ValueError, match="depth targets"):
        diff.fit(p0, [cd], [target_img], config, capacity=512, k_max=32, steps=1,
                 depth_weight=1.0, depth_targets=[dtarget, dtarget], device=CPU)


def test_sh_warmup_masks_band_gradients():
    """Bands above the active degree get no update until their turn."""
    scene, cams, targets = rendered_views(40, 6, 32, 1, sh_degree=2)
    params = diff.from_scene(scene)
    cd = [cams[0].camera_data()]
    kw = dict(capacity=2048, k_max=128, learning_rate=1e-2, l2_weight=1.0, sh_warmup_every=4,
              device=CPU)
    sh0 = params.sh.numpy()
    fitted, _ = diff.fit(params, cd, targets, RenderConfig(screen_size=32), steps=3, **kw)
    sh1 = fitted.sh.numpy()
    np.testing.assert_array_equal(sh1[:, 1:], sh0[:, 1:])
    assert np.any(sh1[:, 0] != sh0[:, 0])
    fitted2, _ = diff.fit(params, cd, targets, RenderConfig(screen_size=32), steps=5, **kw)
    sh2 = fitted2.sh.numpy()
    assert np.any(sh2[:, 1:4] != sh0[:, 1:4])
    np.testing.assert_array_equal(sh2[:, 4:], sh0[:, 4:])
