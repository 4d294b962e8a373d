"""The port's differentiable path around the renderer, against the JAX
package on the CPU: build_structure (exact), the scene conversions, the
initializations and density control (bit-equal: both draw with NumPy), the
pose corrections, and write_fitted_ply (byte-equal).  The counterparts of
tests/test_diff.py's structure, conversion, density and camera tests,
tests/test_colmap.py's test_init_from_points and tests/test_scene_ops.py's
write_fitted_ply case."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cudagaussianrenderer_tpu as jx
from cudagaussianrenderer_torch import cli, diff
from cudagaussianrenderer_torch.config import RenderConfig
from cudagaussianrenderer_torch.models.camera import Camera, quat_to_matrix
from cudagaussianrenderer_torch.models.scene import random_scene
from cudagaussianrenderer_torch.ops.projection import SplatClipData
from cudagaussianrenderer_torch.render import Renderer
from cudagaussianrenderer_torch.splatfile import load_scene
from cudagaussianrenderer_tpu import diff as jdiff

from torch_port_cases import image_close, one_torch_thread  # noqa: F401 (an autouse fixture)

CPU = "cpu"


def T(a) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(np.array(a.view(np.int32) if a.dtype == np.uint32 else a))


def N(a) -> np.ndarray:
    """A tensor or JAX array as NumPy (int32 words as uint32)."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a


def to_port(tree):
    return type(tree)(*(None if a is None else T(a) for a in tree))


def assert_splats_equal(got, want):
    assert got.sh_degree == want.sh_degree
    for name, g, w in zip(want._fields, got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            g, w = N(g), N(w)
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("size,kw", [(128, {}), (64, dict(depth_bits=32))],
                         ids=["packed-key", "lex-key"])
def test_build_structure_exact(size, kw):
    """sids (in order: the sort is stable), starts, counts and the candidate
    count equal the JAX package's: first from JAX's own clip data and colours
    (stage by stage), then end to end from the same parameters."""
    scene = jx.random_scene(350, seed=3, sh_degree=3)
    jc, pc = jx.RenderConfig(screen_size=size, **kw), RenderConfig(screen_size=size, **kw)
    cd = jx.Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max).camera_data()
    params = jdiff.from_scene(scene)
    want = jdiff.build_structure(params, cd, jc, 4096)
    jcam = {k: jnp.asarray(v) for k, v in cd.items()}
    clip, opac = jdiff._project(params, jcam, jc)
    colors = jdiff._diff_colors(params, jcam["position"])
    staged = diff._pair_structure(SplatClipData(*map(T, clip)), T(colors), T(opac), pc,
                                  diff.round_capacity(4096, CPU))
    whole = diff.build_structure(to_port(params), cd, pc, 4096, device=CPU)
    for got in (staged, whole):
        for name, g, w in zip(want._fields, got, want):
            np.testing.assert_array_equal(N(g), N(w), err_msg=name)
    assert int(want.num_candidates) > 500 and diff.max_tile_count(whole) > 8


def test_from_scene_and_to_scene_match_jax():
    """from_scene of the same scene, and to_scene of the same parameters:
    the exact leaves bit-equal, the activated ones (log, exp, sigmoid) to f32
    rounding, the packed rotations equal."""
    js = jx.random_scene(200, seed=6, sh_degree=1)
    ps = random_scene(200, seed=6, sh_degree=1, device=CPU)
    jp, pp = jdiff.from_scene(js), diff.from_scene(ps)
    for name in ("means", "quats", "colors", "sh"):
        np.testing.assert_array_equal(N(getattr(pp, name)), N(getattr(jp, name)), err_msg=name)
    for name in ("log_scales", "opacity_logits"):
        np.testing.assert_allclose(N(getattr(pp, name)), N(getattr(jp, name)), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    got, want = diff.to_scene(to_port(jp)), jdiff.to_scene(jp)
    assert got.count == want.count and got.sh_degree == want.sh_degree
    assert got.bounds_min == want.bounds_min and got.bounds_max == want.bounds_max
    np.testing.assert_array_equal(N(got.quats).view(np.uint32), N(want.quats))
    for name in ("means", "colors", "sh"):
        np.testing.assert_array_equal(N(getattr(got, name)), N(getattr(want, name)))
    for name in ("scales", "opacities"):
        np.testing.assert_allclose(N(getattr(got, name)), N(getattr(want, name)), rtol=1e-6)


def test_to_scene_roundtrip_renders_close():
    """from_scene -> to_scene loses only the 8-bit rotation requantization:
    the round-tripped scene renders within the suite's rule."""
    scene = random_scene(200, seed=6, device=CPU)
    config = RenderConfig(screen_size=64)
    cam = Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    back = diff.to_scene(diff.from_scene(scene))
    image_close(Renderer(back, config, device=CPU).render(cam),
                Renderer(scene, config, device=CPU).render(cam), "to_scene round trip")


@pytest.mark.parametrize("sh_degree", [0, 2])
def test_random_init_bit_equal_to_jax(sh_degree):
    kw = dict(seed=5, scale=0.2, opacity=0.3, sh_degree=sh_degree)
    got = diff.random_init(40, (-1, -2, -3), (1, 2, 3), device=CPU, **kw)
    assert_splats_equal(got, jdiff.random_init(40, (-1, -2, -3), (1, 2, 3), **kw))


def test_init_from_points():
    """tests/test_colmap.py's test_init_from_points on the port, then
    bit-equality with the JAX package on a random cloud, subsampled."""
    xyz = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0], [10, 0, 0]], np.float32)
    rgb = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1]], np.float32)
    p = diff.init_from_points(xyz, rgb, device=CPU)
    assert p.means.shape == (3, 4)
    np.testing.assert_allclose(p.means.numpy().T, xyz, atol=1e-6)
    # Point 0's 3 nearest neighbours are at distances 1, 2, 10.
    np.testing.assert_allclose(p.log_scales.numpy()[:, 0], math.log((1 + 2 + 10) / 3), rtol=1e-5)
    np.testing.assert_allclose(p.log_scales.numpy().std(axis=0), 0.0, atol=1e-7)
    np.testing.assert_allclose(torch.sigmoid(p.opacity_logits).numpy(), 0.1, rtol=1e-5)
    np.testing.assert_allclose(p.colors.numpy().T, rgb, atol=1e-6)
    p1 = diff.init_from_points(xyz, rgb, sh_degree=1, device=CPU)
    assert p1.sh.shape == (3, 4, 4)
    np.testing.assert_allclose(p1.sh.numpy()[:, 0], (rgb.T - 0.5) / 0.28209479177387814,
                               rtol=1e-5)
    assert np.all(p1.sh.numpy()[:, 1:] == 0)
    assert diff.init_from_points(xyz, rgb, max_points=2, device=CPU).means.shape == (3, 2)
    pd = diff.init_from_points(np.zeros((3, 3), np.float32), np.zeros((3, 3), np.float32),
                               device=CPU)
    assert torch.isfinite(pd.log_scales).all()
    with pytest.raises(ValueError, match="empty"):
        diff.init_from_points(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
                              device=CPU)

    rng = np.random.default_rng(2)
    cloud = rng.normal(size=(500, 3)).astype(np.float32)
    colours = rng.uniform(-0.1, 1.1, (500, 3)).astype(np.float32)
    for kw in (dict(), dict(sh_degree=3, max_points=300, seed=4, opacity=0.3)):
        assert_splats_equal(diff.init_from_points(cloud, colours, device=CPU, **kw),
                            jdiff.init_from_points(cloud, colours, **kw))


def _densify_params(n=6):
    rng = np.random.default_rng(1)
    return diff.DiffSplats(
        means=torch.zeros((3, n)),
        log_scales=torch.from_numpy(np.log(np.array(
            [[0.01, 0.01, 0.5, 0.5, 0.01, 0.01]] * 3, np.float32))),
        # splat 4 is below the 1/255 prune floor; the others mid-range.
        quats=torch.from_numpy(rng.normal(size=(4, n)).astype(np.float32)),
        opacity_logits=torch.tensor([0.0, 0.0, 0.0, 0.0, -8.0, 0.0]),
        colors=torch.full((3, n), 0.5),
    )


def test_densify_and_prune_rules():
    """Clone small hot splats, split large hot ones (two shrunk samples,
    parent removed), prune sub-floor opacities; max_splats caps growth."""
    params = _densify_params()
    # hot: 0 (small -> clone), 2 (large -> split); 4 is hot but pruned.
    g = np.array([1.0, 0.0, 1.0, 0.0, 1.0, 0.0], np.float32)
    out = diff.densify_and_prune(params, g, grad_threshold=0.5, dense_scale=0.1,
                                 scene_extent=1.0)
    # survivors 0, 1, 3, 5 + the clone of 0 + the 2 children of 2.
    assert out.means.shape[-1] == 4 + 1 + 2
    child = np.isclose(out.log_scales.numpy()[0], np.log(0.5) - np.log(1.6), atol=1e-5)
    assert child.sum() == 2
    capped = diff.densify_and_prune(params, g, grad_threshold=0.5, dense_scale=0.1,
                                    scene_extent=1.0, max_splats=4)
    assert capped.means.shape[-1] == 5


@pytest.mark.parametrize("max_splats", [None, 70])
def test_densify_and_prune_bit_equal_to_jax(max_splats):
    """A random cloud with clones, splits (the NumPy draws) and prunes, SH
    carried along: the same splats as the JAX package, bit for bit."""
    rng = np.random.default_rng(8)
    n = 60
    params = diff.DiffSplats(
        means=T(rng.normal(size=(3, n)).astype(np.float32)),
        log_scales=T(np.log(rng.uniform(0.005, 0.2, (3, n))).astype(np.float32)),
        quats=T(rng.normal(size=(4, n)).astype(np.float32)),
        opacity_logits=T(rng.normal(0, 4, n).astype(np.float32)),
        colors=T(rng.uniform(0, 1, (3, n)).astype(np.float32)),
        sh=T(rng.normal(size=(3, 4, n)).astype(np.float32)),
    )
    g = rng.uniform(0, 1e-3, n).astype(np.float32)
    kw = dict(grad_threshold=4e-4, dense_scale=0.05, scene_extent=1.5, seed=11,
              max_splats=max_splats)
    got = diff.densify_and_prune(params, g, **kw)
    want = jdiff.densify_and_prune(jdiff.DiffSplats(*(jnp.asarray(N(a)) for a in params)), g,
                                   **kw)
    assert got.means.shape[-1] != n
    assert_splats_equal(got, want)


def test_apply_camera_delta_identity_and_host_parity():
    """Zero deltas are exactly the identity; a finite delta applied to the
    camera's tensors matches baking it into a host Camera, and the JAX
    package's apply_camera_delta."""
    cam = Camera(aspect=1.0).framed((-1.0,) * 3, (1.0,) * 3)
    cd = cam.camera_data()
    tcam = diff._camera(cd, CPU)
    out = diff.apply_camera_delta(tcam, torch.zeros(3), torch.zeros(3))
    np.testing.assert_array_equal(out["view"].numpy(), cd["view"])
    np.testing.assert_array_equal(out["position"].numpy(), cd["position"])

    dr = np.array([0.03, -0.02, 0.05], np.float32)
    dt = np.array([0.1, -0.2, 0.05], np.float32)
    out = diff.apply_camera_delta(tcam, torch.from_numpy(dr), torch.from_numpy(dt))
    baked = diff.refined_camera(cam, dr, dt).camera_data()
    np.testing.assert_allclose(out["view"].numpy(), baked["view"], atol=2e-6)
    np.testing.assert_allclose(out["position"].numpy(), baked["position"], atol=2e-6)
    np.testing.assert_array_equal(out["fov_cotangent"].numpy(), cd["fov_cotangent"])
    jout = jdiff.apply_camera_delta({k: jnp.asarray(v) for k, v in cd.items()},
                                    jnp.asarray(dr), jnp.asarray(dt))
    for k in ("view", "position"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), atol=1e-6)
    jcam = jx.Camera(position=cam.position, rotation=cam.rotation, aspect=1.0)
    jbaked = jdiff.refined_camera(jcam, dr, dt)
    got = diff.refined_camera(cam, dr, dt)
    np.testing.assert_allclose(got.position, jbaked.position, atol=1e-6)
    np.testing.assert_allclose(got.rotation, jbaked.rotation, atol=1e-6)


def test_rodrigues_matches_axis_angle_and_grad_at_zero():
    rng = np.random.default_rng(5)
    for _ in range(5):
        axis = rng.standard_normal(3)
        axis /= np.linalg.norm(axis)
        angle = rng.uniform(0.01, 2.5)
        h = angle / 2
        q = np.concatenate([[np.cos(h)], np.sin(h) * axis]).astype(np.float32)
        r = (angle * axis).astype(np.float32)
        got = diff._rodrigues(torch.from_numpy(r)).numpy()
        np.testing.assert_allclose(got, quat_to_matrix(q), atol=1e-5)
        np.testing.assert_allclose(got, np.asarray(jdiff._rodrigues(jnp.asarray(r))), atol=1e-6)
    # The gradient is finite exactly at zero (the Taylor branch), and JAX's.
    r = torch.zeros(3, requires_grad=True)
    torch.sum(diff._rodrigues(r) * 2.0).backward()
    want = jax.grad(lambda v: jnp.sum(jdiff._rodrigues(v) * 2.0))(jnp.zeros(3))
    assert torch.isfinite(r.grad).all()
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("sh_degree", [0, 2])
def test_write_fitted_ply_byte_equal_to_jax(tmp_path, sh_degree):
    """The same parameters written by both packages: the same bytes."""
    jp = jdiff.random_init(30, (-1, -1, -1), (1, 1, 1), seed=3, sh_degree=sh_degree)
    diff.write_fitted_ply(tmp_path / "port.ply", to_port(jp))
    jdiff.write_fitted_ply(tmp_path / "jax.ply", jp)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()


def test_cli_merge_and_convert_fitted_plys(tmp_path):
    """tests/test_scene_ops.py's write_fitted_ply case: fitted .ply files
    through the port's merge and convert with edits."""
    a, b = tmp_path / "a.ply", tmp_path / "b.ply"
    diff.write_fitted_ply(a, diff.from_scene(random_scene(20, seed=1, device=CPU)))
    diff.write_fitted_ply(b, diff.from_scene(random_scene(10, seed=2, device=CPU)))
    out = tmp_path / "m.splat"
    cli.main(["merge", str(a), str(b), "-o", str(out), "--max-splats", "25", "--device", CPU])
    m = load_scene(out, device=CPU)
    assert m.count == 25
    out2 = tmp_path / "c.ply"
    cli.main(["convert", str(out), str(out2), "--translate", "1,0,0", "--scale", "2",
              "--device", CPU])
    c = load_scene(out2, device=CPU)
    assert c.count == 25
    np.testing.assert_allclose(
        c.means.numpy()[:, :c.count],
        2.0 * m.means.numpy()[:, :m.count] + np.array([[1], [0], [0]], np.float32), atol=1e-4)
