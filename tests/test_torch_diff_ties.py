"""The gradient of the port's stages A-B where a clip ties with its bound,
against jax.grad of the JAX package's stages.

jnp.clip, jnp.maximum and jnp.minimum split the gradient in half between
the value and a bound it equals; torch.clamp passes all of it to the value.
Colours at exactly 0 or 1 are common (a .splat or PNG colour is k/255), so
the port's stages clip through ops.geometry.clip (torch.maximum and
torch.minimum), whose gradient is JAX's.  Forward values stay bit-equal to
torch.clamp's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cudagaussianrenderer_torch as pt
import cudagaussianrenderer_tpu as jx
from cudagaussianrenderer_torch.ops import geometry, projection, sh
from cudagaussianrenderer_torch.render import camera_tensors
from cudagaussianrenderer_tpu.ops.projection import project_splats as jx_project
from cudagaussianrenderer_tpu.ops.sh import evaluate_sh_colors as jx_sh

from torch_port_cases import one_torch_thread  # noqa: F401 (an autouse fixture)

SH_C0 = 0.28209479177387814
# Gradients of the same f32 formulas in the same order: a few f32 ULP.
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6


def _torch_grad(fn, *xs):
    xs = [torch.tensor(np.asarray(x), requires_grad=True) for x in xs]
    torch.sum(fn(*xs)).backward()
    return [x.grad.numpy() for x in xs]


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.0, None), (None, 1.0)])
def test_clip_gradient_at_ties_matches_jnp(lo, hi):
    """x sits on each bound, inside and outside: the gradient is jax.grad's
    of jnp.clip (jnp.maximum, jnp.minimum); torch.clamp's is not."""
    x = np.array([-0.5, 0.0, 0.5, 1.0, 1.5], np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(jnp.clip(v, lo, hi)))(jnp.asarray(x)))
    (got,) = _torch_grad(lambda v: geometry.clip(v, lo, hi), x)
    np.testing.assert_array_equal(got, want)
    (clamped,) = _torch_grad(lambda v: torch.clamp(v, lo, hi), x)
    assert not np.array_equal(clamped, want)  # the fault the helper repairs
    np.testing.assert_array_equal(geometry.clip(torch.from_numpy(x), lo, hi).numpy(),
                                  torch.clamp(torch.from_numpy(x), lo, hi).numpy())


def _dc_at(value):
    """A float32 DC coefficient whose SH colour C0 * dc + 0.5 rounds to
    exactly ``value`` (0 or 1) in float32."""
    start = np.float32((value - 0.5) / SH_C0)
    for direction in (np.float32(np.inf), np.float32(-np.inf)):
        dc = start
        for _ in range(64):
            if np.float32(np.float32(SH_C0) * dc) + np.float32(0.5) == np.float32(value):
                return dc
            dc = np.nextafter(dc, direction)
    raise AssertionError("no coefficient found")


def test_sh_colour_at_the_bound_gradient_matches_jax():
    """Stage A's colour lands exactly on 0 and 1 for some splats: the
    gradient of a weighted sum of the colours by the SH coefficients and the
    means is jax.grad's."""
    rng = np.random.default_rng(4)
    n, degree = 12, 1
    k = (degree + 1) ** 2
    means = rng.uniform(-1, 1, (3, n)).astype(np.float32)
    coef = rng.normal(0, 0.3, (3, k, n)).astype(np.float32)
    pos = np.array([3.0, 2.0, 5.0], np.float32)
    # Splats 0-3: DC on a bound and view-dependent bands off, so the
    # colour is exactly 0 or 1 in every channel.
    for i, v in enumerate((0.0, 1.0, 0.0, 1.0)):
        coef[:, 0, i] = _dc_at(v)
        coef[:, 1:, i] = 0.0
    w = rng.normal(size=(3, n)).astype(np.float32)

    colours = sh.evaluate_sh_colors(
        torch.from_numpy(means), torch.from_numpy(coef), torch.from_numpy(pos), degree)
    assert set(colours[:, :4].flatten().tolist()) == {0.0, 1.0}
    want = jax.grad(lambda m, c: jnp.sum(jx_sh(m, c, jnp.asarray(pos), degree) * w),
                    argnums=(0, 1))(jnp.asarray(means), jnp.asarray(coef))
    got = _torch_grad(
        lambda m, c: sh.evaluate_sh_colors(m, c, torch.from_numpy(pos), degree)
        * torch.from_numpy(w), means, coef)
    for g, jw in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(jw), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # At the bound JAX passes half: the first four splats' DC gradient is
    # w * C0 / 2.
    np.testing.assert_allclose(got[1][:, 0, :4], w[:, :4] * SH_C0 / 2, rtol=1e-6)


def test_projection_gradient_matches_jax():
    """Stage B's outputs (centre, depth, conic, extents with opacity-aware
    truncation) by means, scales, quaternion components and opacities:
    the gradient of a weighted sum is jax.grad's."""
    rng = np.random.default_rng(7)
    n = 40
    means = rng.uniform(-1, 1, (3, n)).astype(np.float32)
    scales = rng.uniform(0.05, 0.3, (3, n)).astype(np.float32)
    q = rng.normal(size=(4, n)).astype(np.float32)
    q /= np.linalg.norm(q, axis=0)
    opac = rng.uniform(0.05, 0.9, n).astype(np.float32)
    cd = jx.Camera(aspect=1.0).framed((-1.0,) * 3, (1.0,) * 3).camera_data()
    fields = ("cx", "cy", "z", "e0", "e1", "con_a", "con_b", "con_c")
    w = rng.normal(size=(len(fields), n)).astype(np.float32)
    jc, pc = jx.RenderConfig(screen_size=64), pt.RenderConfig(screen_size=64)

    def jloss(m, s, qq, o):
        c = jx_project(m, s, None, {k: jnp.asarray(v) for k, v in cd.items()}, jc,
                       opacities=o, quat_components=tuple(qq))
        return jnp.sum(jnp.stack([getattr(c, f) for f in fields]) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (means, scales, q, opac)))
    cam = camera_tensors(cd, "cpu")

    def ploss(m, s, qq, o):
        c = projection.project_splats(m, s, None, cam, pc, opacities=o,
                                      quat_components=tuple(qq))
        return torch.stack([getattr(c, f) for f in fields]) * torch.from_numpy(w)

    got = _torch_grad(ploss, means, scales, q, opac)
    for g, jw in zip(got, want):
        jw = np.asarray(jw)
        np.testing.assert_allclose(g, jw, rtol=1e-4, atol=1e-4 * np.abs(jw).max())


def test_stage_ab_forward_bit_equal_to_clamp(monkeypatch):
    """Stages A and B with the repaired clips give bit for bit what they gave
    with torch.clamp: the repair moves gradients, never values."""
    scene = pt.random_scene(500, seed=2, sh_degree=3, device="cpu")
    cam = camera_tensors(
        jx.Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max).camera_data(), "cpu")
    configs = [pt.RenderConfig(screen_size=64),
               pt.RenderConfig(screen_size=64, falloff="epanechnikov")]

    def run():
        outs = [sh.evaluate_sh_colors(scene.means, scene.sh, cam["position"], 3)]
        for cfg in configs:
            outs += list(projection.project_splats(scene.means, scene.scales, scene.quats, cam,
                                                   cfg, opacities=scene.opacities))
        return outs

    new = run()

    def clamp(x, lo=None, hi=None):
        return torch.clamp(x, lo, hi)

    monkeypatch.setattr(sh, "clip", clamp)
    monkeypatch.setattr(projection, "clip", clamp)
    old = run()
    for a, b in zip(new, old):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
