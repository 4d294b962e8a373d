"""The port's differentiable renderer (cudagaussianrenderer_torch.diff) on the
CPU: render_diff's image, depth and gradients against the JAX package's on
the same parameters and the same pair structure, then the counterparts of
tests/test_diff.py's renderer tests (golden oracle, finite differences,
culled and empty frames, k_max, expected depth, remat) and of
tests/test_background.py's diff case.

Parity runs on the JAX package's structure, converted: one f32 ULP of
projection can move a tile edge, and build_structure has its own exact test
(tests/test_torch_diff_structure.py).  Tolerances: the blend is the same f32
formulas in the same order but with other exp/log1p/cumsum implementations
and a matmul for the weighted sums, so images and depth agree within
IMG_TOL absolute; a gradient is a sum over thousands of pairs, so each leaf
is held within GRAD_RTOL of its own largest |gradient|."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cudagaussianrenderer_tpu as jx
from cudagaussianrenderer_torch import diff
from cudagaussianrenderer_torch.config import RenderConfig
from cudagaussianrenderer_torch.golden import golden_render, scene_to_numpy
from cudagaussianrenderer_torch.models.camera import Camera
from cudagaussianrenderer_torch.models.scene import random_scene
from cudagaussianrenderer_torch.render import Renderer
from cudagaussianrenderer_tpu import diff as jdiff

from torch_port_cases import image_close, one_torch_thread  # noqa: F401 (an autouse fixture)

IMG_TOL = 1e-5
GRAD_RTOL = 1e-4
CPU = "cpu"


def T(a) -> torch.Tensor:
    """A JAX or NumPy array as a CPU tensor (uint32 as int32 bits)."""
    a = np.asarray(a)
    return torch.from_numpy(np.array(a.view(np.int32) if a.dtype == np.uint32 else a))


def to_port(tree):
    """A JAX NamedTuple of arrays as the port's (tensors, None kept)."""
    return type(tree)(*(None if a is None else T(a) for a in tree))


def grads_of(loss_fn, *trees):
    """torch.autograd gradients of loss_fn(*trees) for every leaf, zeros
    for leaves the loss does not reach (as jax.grad gives)."""
    trees = [diff.tree_map(lambda a: a.detach().clone().requires_grad_(True), t) for t in trees]
    out = loss_fn(*trees)
    loss = out[0] if isinstance(out, tuple) else out
    leaves = [leaf for t in trees for leaf in diff.tree_leaves(t)]
    g = [None] * len(leaves)
    if loss.requires_grad:  # a frame without pairs does not depend on the leaves
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
    g = [torch.zeros_like(x) if gi is None else gi for gi, x in zip(g, leaves)]
    return out, g


@pytest.fixture(scope="module")
def reference():
    """A 64x64 frame of 300 splats (SH 2) with a pose correction and an
    exposure: the JAX package's structure, image, depth and gradients."""
    scene = jx.random_scene(300, seed=2, sh_degree=2)
    config = jx.RenderConfig(screen_size=64)
    cd = jx.Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max).camera_data()
    params = jdiff.from_scene(scene)
    structure = jdiff.build_structure(params, cd, config, 4096)
    k_max = max(8, jdiff.max_tile_count(structure))
    extras = (jdiff.CameraDeltas(dr=jnp.asarray([0.01, -0.02, 0.015]),
                                 dt=jnp.asarray([0.05, 0.02, -0.03])),
              jdiff.Exposure(gain=jnp.asarray([1.1, 0.9, 1.0]),
                             bias=jnp.asarray([0.01, 0.0, -0.02])))
    w = np.random.default_rng(0).normal(size=(64, 64, 3)).astype(np.float32)
    jcam = {k: jnp.asarray(v) for k, v in cd.items()}

    def loss(p, ex):
        cam = jdiff.apply_camera_delta(jcam, ex[0].dr, ex[0].dt)
        image, depth, _ = jdiff.render_diff(p, cam, config, 4096, k_max, structure=structure,
                                            return_depth=True)
        rgb = image[..., :3] * ex[1].gain + ex[1].bias
        return jnp.sum(rgb * w) + jnp.sum(depth), (image, depth)

    (_, (image, depth)), grads = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(params, extras)
    return dict(cd=cd, params=params, structure=structure, k_max=k_max, extras=extras, w=w,
                image=np.asarray(image), depth=np.asarray(depth),
                grads=[np.asarray(g) for g in jax.tree_util.tree_leaves(grads)])


def _port_loss(ref, **kw):
    w = torch.from_numpy(ref["w"])
    structure = to_port(ref["structure"])
    cam = diff._camera(ref["cd"], CPU)

    def loss(p, ex):
        c = diff.apply_camera_delta(cam, ex[0].dr, ex[0].dt)
        image, depth, _ = diff.render_diff(p, c, RenderConfig(screen_size=64), 4096,
                                           ref["k_max"], structure=structure, return_depth=True,
                                           device=CPU, **kw)
        rgb = image[..., :3] * ex[1].gain + ex[1].bias
        return torch.sum(rgb * w) + torch.sum(depth), image.detach(), depth.detach()

    return loss


def test_forward_matches_jax(reference):
    (_, image, depth), _ = grads_of(_port_loss(reference), to_port(reference["params"]),
                                    tuple(map(to_port, reference["extras"])))
    assert image.shape == (64, 64, 4) and depth.shape == (64, 64)
    np.testing.assert_allclose(image.numpy(), reference["image"], rtol=0, atol=IMG_TOL)
    np.testing.assert_allclose(depth.numpy(), reference["depth"], rtol=0, atol=IMG_TOL)
    assert reference["image"][..., :3].max() > 0.1


def test_gradients_match_jax(reference):
    """Every DiffSplats leaf, CameraDeltas and Exposure, against jax.grad."""
    _, got = grads_of(_port_loss(reference), to_port(reference["params"]),
                      tuple(map(to_port, reference["extras"])))
    assert len(got) == len(reference["grads"]) == 10
    for g, want in zip(got, reference["grads"]):
        assert g.shape == want.shape
        scale = np.abs(want).max()
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=GRAD_RTOL * max(scale, 1e-30))


def _same_result(ref, kw_a, kw_b):
    p, ex = to_port(ref["params"]), tuple(map(to_port, ref["extras"]))
    (loss_a, img_a, dep_a), ga = grads_of(_port_loss(ref, **kw_a), p, ex)
    (loss_b, img_b, dep_b), gb = grads_of(_port_loss(ref, **kw_b), p, ex)
    assert torch.equal(loss_a, loss_b)
    assert torch.equal(img_a, img_b) and torch.equal(dep_a, dep_b)
    for a, b in zip(ga, gb):
        assert torch.equal(a, b)


def test_remat_gradients_match(reference):
    """Checkpointed chunks change memory, not math: the loss, image and
    every gradient are identical with and without remat."""
    _same_result(reference, dict(remat=False), dict(remat=True))


def test_tile_batch_does_not_change_the_result(reference):
    """Blocks of 64 tiles (all 16 tiles at once) against blocks of 5:
    identical images and gradients (the pair gradients are summed in
    float64, so the blocks' order of summation does not show)."""
    _same_result(reference, dict(tile_batch=64), dict(tile_batch=5))


def _structure_and_kmax(params, cam_data, config, capacity):
    structure = diff.build_structure(params, cam_data, config, capacity, device=CPU)
    return structure, max(8, diff.max_tile_count(structure))


@pytest.mark.parametrize("n,seed,size,kw", [
    (300, 2, 128, {}),
    (200, 5, 64, dict(falloff="epanechnikov")),
    (150, 7, 64, dict(sh_degree=2)),
], ids=["gaussian", "epanechnikov", "sh"])
def test_forward_matches_golden(n, seed, size, kw):
    """The counterparts of test_forward_matches_golden and its epanechnikov
    and SH variants: the full-precision diff forward against the f64
    oracle, held to the suite's rule."""
    sh_degree = kw.pop("sh_degree", 0)
    scene = random_scene(n, seed=seed, sh_degree=sh_degree, device=CPU)
    config = RenderConfig(screen_size=size, **kw)
    cam_data = Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max).camera_data()
    params = diff.from_scene(scene)
    assert params.sh_degree == sh_degree
    structure, k_max = _structure_and_kmax(params, cam_data, config, 4096)
    image, _ = diff.render_diff(params, cam_data, config, 4096, k_max, structure=structure,
                                device=CPU)
    got = (image[..., :3] * 255.0 + 0.5).to(torch.int32).numpy()
    want = golden_render(scene_to_numpy(scene), cam_data, config)[..., :3]
    image_close(got, want, "render_diff vs golden")
    assert got.max() > 32


def _tiny_setup(sh_degree=0):
    """test_diff.py's smooth test point: mid-range opacities and colours, no
    pixel at the [0, 1] clip, the structure frozen."""
    rng = np.random.default_rng(11)
    n = 8
    means = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    scales = rng.uniform(0.2, 0.5, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    opac = rng.uniform(0.3, 0.6, n).astype(np.float32)
    colors = rng.uniform(0.2, 0.7, (n, 3)).astype(np.float32)
    sh = None
    if sh_degree:
        k = (sh_degree + 1) ** 2
        sh = np.zeros((n, k, 3), np.float32)
        sh[:, 0] = (colors - 0.5) / 0.28209479177387814
        sh[:, 1:] = rng.normal(scale=0.05, size=(n, k - 1, 3))
    params = diff.DiffSplats(
        means=T(means.T), log_scales=T(np.log(scales).T), quats=T(q.T),
        opacity_logits=T(np.log(opac) - np.log1p(-opac)), colors=T(colors.T),
        sh=None if sh is None else T(np.transpose(sh, (2, 1, 0))),
    )
    config = RenderConfig(screen_size=32)
    cam_data = Camera(aspect=1.0).framed((-1.0,) * 3, (1.0,) * 3).camera_data()
    structure, k_max = _structure_and_kmax(params, cam_data, config, 1024)
    w = torch.from_numpy(rng.normal(size=(32, 32, 3)).astype(np.float32))

    def loss(p):
        img, _ = diff.render_diff(p, cam_data, config, 1024, k_max, structure=structure,
                                  device=CPU)
        return torch.sum(img[..., :3] * w)

    return params, loss


@pytest.mark.parametrize("sh_degree", [0, 1])
def test_gradients_match_finite_differences(sh_degree):
    params, loss = _tiny_setup(sh_degree)
    _, grads = grads_of(loss, params)
    named = [(f, getattr(params, f)) for f in params._fields if getattr(params, f) is not None]
    rng = np.random.default_rng(3)
    checked = 0
    with torch.no_grad():
        for (name, leaf), g in zip(named, grads):
            arr = leaf.numpy()
            for fi in rng.choice(arr.size, size=min(4, arr.size), replace=False):
                idx = np.unravel_index(fi, arr.shape)
                eps = 3e-3
                plus, minus = arr.copy(), arr.copy()
                plus[idx] += eps
                minus[idx] -= eps
                lp = float(loss(params._replace(**{name: T(plus)})))
                lm = float(loss(params._replace(**{name: T(minus)})))
                fd = (lp - lm) / (2 * eps)
                ad = float(g[idx])
                assert abs(fd - ad) <= 2e-2 * max(1.0, abs(fd), abs(ad)), (
                    f"{name}{idx}: fd={fd:.5f} ad={ad:.5f}")
                checked += 1
    assert checked >= 20


def test_gradients_finite_everywhere():
    """No NaN or inf in any gradient leaf, culled splats, saturated and
    empty tiles included."""
    scene = random_scene(100, seed=9, device=CPU)
    config = RenderConfig(screen_size=64)
    cam_data = Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max).camera_data()
    params = diff.from_scene(scene)
    structure, k_max = _structure_and_kmax(params, cam_data, config, 4096)

    def loss(p):
        img, _ = diff.render_diff(p, cam_data, config, 4096, k_max, structure=structure,
                                  device=CPU)
        return torch.mean(img[..., :3] ** 2)

    _, grads = grads_of(loss, params)
    for g in grads:
        assert torch.isfinite(g).all()


def test_empty_frame_renders_black_with_finite_grads():
    """A camera looking away from every splat: zero pairs, a black image,
    and all-zero but finite gradients."""
    scene = random_scene(50, seed=1, device=CPU)
    config = RenderConfig(screen_size=32)
    cam_data = Camera(aspect=1.0, position=np.array([500.0, 500.0, 500.0])).camera_data()
    params = diff.from_scene(scene)
    structure = diff.build_structure(params, cam_data, config, 1024, device=CPU)
    assert diff.max_tile_count(structure) == 0

    def loss(p):
        img, _ = diff.render_diff(p, cam_data, config, 1024, 8, structure=structure, device=CPU)
        return torch.sum(img[..., :3])

    val, grads = grads_of(loss, params)
    assert float(val) == 0.0
    for g in grads:
        assert torch.isfinite(g).all() and float(g.abs().max()) == 0.0


def test_degree0_sh_params_render():
    """DiffSplats with a K=1 SH tensor uses the DC band's affine map."""
    scene = random_scene(100, seed=3, device=CPU)
    config = RenderConfig(screen_size=64)
    cam_data = Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max).camera_data()
    p0 = diff.from_scene(scene)
    sh = ((torch.clamp(p0.colors, 0, 1) - 0.5) / 0.28209479177387814)[:, None]
    p1 = p0._replace(sh=sh)
    assert p1.sh_degree == 0
    st = diff.build_structure(p1, cam_data, config, 4096, device=CPU)
    k = max(8, diff.max_tile_count(st))
    a, _ = diff.render_diff(p0, cam_data, config, 4096, k, structure=st, device=CPU)
    b, _ = diff.render_diff(p1, cam_data, config, 4096, k, structure=st, device=CPU)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_k_max_truncation_is_prefix():
    """k_max below the largest tile count drops the BACK of each tile's
    list: the truncated image never exceeds the full one."""
    scene = random_scene(300, seed=2, device=CPU)
    config = RenderConfig(screen_size=64)
    cam_data = Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max).camera_data()
    params = diff.from_scene(scene)
    structure, k_max = _structure_and_kmax(params, cam_data, config, 4096)
    full, _ = diff.render_diff(params, cam_data, config, 4096, k_max, structure=structure,
                               device=CPU)
    half, _ = diff.render_diff(params, cam_data, config, 4096, max(8, k_max // 2),
                               structure=structure, device=CPU)
    assert not torch.equal(full, half)
    assert bool(torch.all(half[..., :3] <= full[..., :3] + 1e-4))


def test_expected_depth_blend_and_grads():
    """return_depth: two huge stacked splats give a centre-pixel depth of
    a1 z1 + (1 - a1) a2 z2 with z from the projection, and gradients reach
    the means through the depth."""
    means = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, -1.0]], np.float32)
    opac = np.array([0.4, 0.7], np.float32)
    params = diff.DiffSplats(
        means=T(means.T), log_scales=T(np.log(np.full((3, 2), 1.2, np.float32))),
        quats=T(np.tile(np.array([0, 0, 0, 1], np.float32), (2, 1)).T),
        opacity_logits=T(np.log(opac) - np.log1p(-opac)),
        colors=T(np.full((3, 2), 0.5, np.float32)),
    )
    config = RenderConfig(screen_size=32)
    cd = Camera(position=np.array([0, 0, 6], np.float32)).camera_data()
    image, depth, structure = diff.render_diff(params, cd, config, 1024, 64, return_depth=True,
                                               device=CPU)
    assert depth.shape == (32, 32)
    clip, opacities = diff._project(params, diff._camera(cd, CPU), config)
    z, a = clip.z.numpy(), opacities.numpy()
    order = np.argsort(z)
    a1, a2, z1, z2 = a[order[0]], a[order[1]], z[order[0]], z[order[1]]
    assert float(depth[16, 16]) == pytest.approx(float(a1 * z1 + (1 - a1) * a2 * z2), rel=0.02)

    def loss(p):
        return torch.sum(diff.render_diff(p, cd, config, 1024, 64, structure=structure,
                                          return_depth=True, device=CPU)[1])

    _, grads = grads_of(loss, params)
    gm = grads[0]
    assert torch.isfinite(gm).all() and bool((gm != 0).any())


def test_diff_background_matches_production_and_grads_flow():
    """tests/test_background.py's diff case: with an opaque white
    background the diff frame passes the rule against the production frame,
    and the background reaches the opacity gradients through T."""
    scene = random_scene(60, seed=5, device=CPU)
    config = RenderConfig(screen_size=64, background=(1.0, 1.0, 1.0))
    cam = Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    cam_data = cam.camera_data()
    params = diff.from_scene(scene)
    structure, k_max = _structure_and_kmax(params, cam_data, config, 4096)
    img, _ = diff.render_diff(params, cam_data, config, 4096, k_max, structure=structure,
                              device=CPU)
    prod = Renderer(scene, config, device=CPU).render(cam)
    image_close((img.numpy() * 255).astype(np.uint8), prod, "diff vs production, white")

    def loss(p):
        im, _ = diff.render_diff(p, cam_data, config, 4096, k_max, structure=structure,
                                 device=CPU)
        return torch.sum(im[..., :3])

    _, grads = grads_of(loss, params)
    g = grads[3]  # opacity_logits
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0
