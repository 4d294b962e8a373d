"""The port's SSIM (cudagaussianrenderer_torch.diff.ssim) against the JAX
package's diff.ssim on the same seeded images.

Tolerance: 1e-6 absolute on the mean SSIM.  Both compute in float32; the
JAX blur is a convolution at HIGHEST precision, the port's a sum of shifted
multiply-adds, and the two exp implementations of the window may differ by
one unit in the last place, so the sums round differently (observed up to
~5e-7 on these inputs).
"""

import numpy as np
import pytest
import torch

from cudagaussianrenderer_torch.diff import ssim as pssim
from cudagaussianrenderer_tpu.diff import ssim as jssim

from torch_port_cases import one_torch_thread  # noqa: F401 (an autouse fixture)

TOL = 1e-6


def _pair(kind, shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    if kind == "noisy":
        b = np.clip(a + rng.normal(0.0, 0.05, shape), 0.0, 1.0).astype(np.float32)
    elif kind == "unrelated":
        b = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    elif kind == "identical":
        b = a.copy()
    elif kind == "flat-pair":
        a = np.full(shape, 0.5, np.float32)
        b = a.copy()
    elif kind == "flat-vs-noise":
        a = np.full(shape, 0.25, np.float32)
        b = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    elif kind == "smooth-shifted":
        y, x = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float32)
        a = np.repeat((0.5 + 0.4 * np.sin(x / 5.0) * np.cos(y / 7.0))[..., None], 3, 2)
        b = np.roll(a, 1, axis=1).astype(np.float32)
        a = a.astype(np.float32)
    return a, b


KINDS = ["noisy", "unrelated", "identical", "flat-pair", "flat-vs-noise", "smooth-shifted"]
SHAPES = [(32, 32, 3), (17, 23, 3), (64, 48, 3)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", KINDS)
def test_ssim_matches_jax(kind, shape):
    a, b = _pair(kind, shape, seed=shape[0] * 7 + shape[1])
    want = float(np.asarray(jssim(a, b)))
    got = pssim(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= TOL, (float(got), want)
    if kind in ("identical", "flat-pair"):
        assert float(got) == 1.0
    assert -1.0 <= float(got) <= 1.0


@pytest.mark.parametrize("window,sigma", [(7, 1.0), (11, 3.0)])
def test_ssim_window_options_match_jax(window, sigma):
    a, b = _pair("noisy", (40, 40, 3), seed=3)
    want = float(np.asarray(jssim(a, b, window=window, sigma=sigma)))
    assert abs(float(pssim(a, b, window=window, sigma=sigma)) - want) <= TOL


def test_ssim_takes_numpy_and_is_differentiable():
    a, b = _pair("noisy", (24, 24, 3), seed=5)
    assert float(pssim(a, b)) == float(pssim(torch.from_numpy(a), torch.from_numpy(b)))
    ta = torch.from_numpy(a).requires_grad_(True)
    loss = 1.0 - pssim(ta, torch.from_numpy(b))
    loss.backward()
    assert ta.grad is not None and torch.isfinite(ta.grad).all()
    # A flat image has zero variance: the clamps keep the value and its
    # gradient finite.
    flat = torch.full((16, 16, 3), 0.5, requires_grad=True)
    s = pssim(flat, torch.from_numpy(_pair("noisy", (16, 16, 3), 1)[1]))
    s.backward()
    assert -1.0 <= float(s.detach()) <= 1.0 and torch.isfinite(flat.grad).all()
