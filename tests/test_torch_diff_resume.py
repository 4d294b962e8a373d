"""The port's fit against the JAX package's on the same targets, and
checkpoints that cross between them: a 5-step Adam fit with pose and
exposure refinement, whose losses and fitted parameters track JAX's; a
3-step fit of each package, checkpointed and resumed by the other to step
5, against the other's uninterrupted run; and the counterpart of
tests/test_diff.py's test_checkpoint_resume_continues_trajectory.

The targets come from the port's Renderer (both packages fit the same
arrays).  Losses agree within LOSS_RTOL and parameters within PARAM_ATOL:
the same f32 arithmetic, whose rounding differences grow a little each step.
A resume restarts the per-view extras' Adam moments (they are not
checkpointed, in either package), so a resumed run agrees with an
uninterrupted one within RESUME_ATOL, the JAX test's tolerance."""

import numpy as np
import optax
import pytest
import torch

from cudagaussianrenderer_torch import diff
from cudagaussianrenderer_torch.config import RenderConfig
from cudagaussianrenderer_tpu import diff as jdiff
from cudagaussianrenderer_tpu.config import RenderConfig as JRenderConfig

from torch_port_cases import one_torch_thread, rendered_views  # noqa: F401 (one_torch_thread: an autouse fixture)

LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-4
RESUME_ATOL = 3e-3
CPU = "cpu"
KW = dict(capacity=2048, k_max=128, l2_weight=1.0, optimize_cameras=True, camera_lr=1e-3,
          optimize_exposure=True, exposure_lr=1e-2)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_close(got, want, atol):
    """The fitted splats, pose deltas and exposure of two fit outputs
    (params, losses, deltas, exposure) of either package."""
    for a, b in zip(got[:1] + got[2:], want[:1] + want[2:]):
        for x, y in zip(a, b):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_allclose(_np(x), _np(y), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Uninterrupted 5-step fits and 3-step checkpointed fits of both
    packages from the same initial splats and targets."""
    tmp = tmp_path_factory.mktemp("fits")
    scene, cams, targets = rendered_views(40, 2, 32, 2)
    cam_data = [c.camera_data() for c in cams]
    jinit = jdiff.random_init(30, scene.bounds_min, scene.bounds_max, seed=1)
    pinit = diff.random_init(30, scene.bounds_min, scene.bounds_max, seed=1, device=CPU)
    jcfg, pcfg = JRenderConfig(screen_size=32), RenderConfig(screen_size=32)
    jtx, ptx = optax.adam(5e-3), diff.Adam(5e-3)
    out = dict(cam_data=cam_data, targets=targets, jcfg=jcfg, pcfg=pcfg, jtx=jtx, ptx=ptx,
               jck=tmp / "jax.npz", pck=tmp / "port.npz")
    out["jax"] = jdiff.fit(jinit, cam_data, targets, jcfg, steps=5, tx=jtx, **KW)
    out["port"] = diff.fit(pinit, cam_data, targets, pcfg, steps=5, tx=ptx, device=CPU, **KW)
    jdiff.fit(jinit, cam_data, targets, jcfg, steps=3, tx=jtx, checkpoint_every=3,
              checkpoint_path=out["jck"], **KW)
    diff.fit(pinit, cam_data, targets, pcfg, steps=3, tx=ptx, checkpoint_every=3,
             checkpoint_path=out["pck"], device=CPU, **KW)
    return out


def test_fit_tracks_jax(runs):
    """Losses step by step, and the fitted splats, pose deltas and exposure."""
    port, jax_ = runs["port"], runs["jax"]
    assert np.isfinite(port[1]).all() and port[1][-1] < port[1][0]
    np.testing.assert_allclose(port[1], jax_[1], rtol=LOSS_RTOL)
    _assert_close(port, jax_, PARAM_ATOL)
    # Only the rendered view's row of the extras moves: 5 steps over two
    # views move both rows.
    assert (port[2].dr.abs().sum(dim=1) > 0).all() and (port[3].gain != 1).any()


def _resume(fit, ck, runs, tx, cfg, **extra):
    return fit(ck["params"], runs["cam_data"], runs["targets"], cfg, steps=5, tx=tx,
               start_step=ck["step"], opt_state=ck["opt_state"],
               camera_deltas=ck["camera_deltas"], exposure=ck["exposure"], **KW, **extra)


def test_port_resumes_a_jax_checkpoint(runs):
    ck = diff.load_checkpoint(runs["jck"], tx=runs["ptx"], device=CPU)
    assert ck["step"] == 3 and ck["opt_state"] is not None and ck["exposure"] is not None
    resumed = _resume(diff.fit, ck, runs, runs["ptx"], runs["pcfg"], device=CPU)
    np.testing.assert_allclose(resumed[1][3:], runs["jax"][1][3:], atol=RESUME_ATOL)
    _assert_close(resumed, runs["jax"], RESUME_ATOL)


def test_jax_resumes_a_port_checkpoint(runs):
    ck = jdiff.load_checkpoint(runs["pck"], tx=runs["jtx"])
    assert ck["step"] == 3 and ck["opt_state"] is not None and ck["camera_deltas"] is not None
    resumed = _resume(jdiff.fit, ck, runs, runs["jtx"], runs["jcfg"])
    np.testing.assert_allclose(resumed[1][3:], runs["port"][1][3:], atol=RESUME_ATOL)
    _assert_close(resumed, runs["port"], RESUME_ATOL)


def test_checkpoint_resume_continues_trajectory(runs):
    """fit(5) against fit(3) -> checkpoint -> resume(5), all in the port:
    the same optimizer, camera rotation and step indexing."""
    ck = diff.load_checkpoint(runs["pck"], tx=runs["ptx"], device=CPU)
    resumed = _resume(diff.fit, ck, runs, runs["ptx"], runs["pcfg"], device=CPU)
    np.testing.assert_allclose(resumed[1][3:], runs["port"][1][3:], atol=RESUME_ATOL)
    _assert_close(resumed, runs["port"], RESUME_ATOL)
