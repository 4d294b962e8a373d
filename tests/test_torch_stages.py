"""Stages A-C1 of the PyTorch port against the JAX package on the CPU:
spherical harmonics, projection, the attribute packers, the ellipse/rect
test, tile rects, row packs and depth quantization.

Each stage is fed the same inputs as its JAX counterpart (the JAX outputs
of the stage before, where there is one), so one f32 ULP of projection
cannot move a tile edge between the two."""

import numpy as np
import pytest
import torch

import cudagaussianrenderer_torch as pt
import cudagaussianrenderer_tpu as jx
from cudagaussianrenderer_torch.ops import binning as pb
from cudagaussianrenderer_torch.ops import geometry as pg
from cudagaussianrenderer_torch.ops.projection import SplatClipData as PtClip
from cudagaussianrenderer_torch.ops.projection import project_splats as pt_project
from cudagaussianrenderer_torch.ops.sh import evaluate_sh_colors as pt_sh
from cudagaussianrenderer_torch.render import camera_tensors
from cudagaussianrenderer_tpu.ops import binning as jb
from cudagaussianrenderer_tpu.ops import geometry as jg
from cudagaussianrenderer_tpu.ops.projection import project_splats as jx_project
from cudagaussianrenderer_tpu.ops.sh import evaluate_sh_colors as jx_sh

# Float stages (SH, projection) are the same f32 formulas in the same
# order, but XLA and PyTorch's CPU kernels may vectorize, fuse or contract
# them differently (and the SH contraction is a dot product whose sum
# order is the library's), so they agree to a few f32 ULP, not bit for bit.
F32_RTOL = 2e-5
F32_ATOL = 2e-6


def T(a) -> torch.Tensor:
    """A JAX or numpy array as a CPU tensor; uint32 words as int32 bits."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def U32(t: torch.Tensor) -> np.ndarray:
    """int32 bit patterns (the port's words) as uint32."""
    return t.numpy().astype(np.int32).view(np.uint32)


def scenes(n, seed, **kw):
    j = jx.random_scene(n, seed=seed, **kw).pad_to_multiple(256)
    p = pt.random_scene(n, seed=seed, device="cpu", **kw).pad_to_multiple(256)
    return j, p


@pytest.fixture(scope="module")
def scene_pair():
    j, p = scenes(500, 2, sh_degree=4)
    cam = jx.Camera(aspect=1.0).framed(j.bounds_min, j.bounds_max)
    return j, p, cam


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_sh_colors_match(scene_pair, degree):
    j, p, cam = scene_pair
    cd = cam.camera_data()
    want = np.asarray(jx_sh(j.means, j.sh, cd["position"], degree))
    got = pt_sh(p.means, p.sh, camera_tensors(cd, "cpu")["position"], degree).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL)


PROJ_CASES = [
    ("gaussian", dict(screen_size=128), True),
    ("gaussian-full-extents", dict(screen_size=128, opacity_aware_extents=False), True),
    ("epanechnikov", dict(screen_size=128, falloff="epanechnikov"), True),
    ("rect-no-opacity", dict(screen_size=192, screen_height=128), False),
]


def test_clip_data_stacked_views_match(scene_pair):
    """SplatClipData's clip_xy, clip_z, ellipse and conic, stacked in the
    JAX order: exactly the JAX properties on the JAX fields carried across,
    and within f32 tolerance on the port's own projection."""
    j, p, cam = scene_pair
    cfg = dict(screen_size=128)
    cd = cam.camera_data()
    want = jx_project(j.means, j.scales, j.quats, cd, jx.RenderConfig(**cfg),
                      opacities=j.opacities)
    carried = clip_to_torch(want)
    own = pt_project(p.means, p.scales, p.quats, camera_tensors(cd, "cpu"),
                     pt.RenderConfig(**cfg), opacities=p.opacities)
    for view, width in (("clip_xy", 2), ("clip_z", None), ("ellipse", 4), ("conic", 3)):
        w = np.asarray(getattr(want, view))
        n = want.cx.shape[0]
        assert w.shape == ((n,) if width is None else (n, width))
        np.testing.assert_array_equal(getattr(carried, view).numpy(), w, err_msg=view)
        np.testing.assert_allclose(getattr(own, view).numpy(), w, rtol=F32_RTOL, atol=F32_ATOL,
                                   err_msg=view)


@pytest.mark.parametrize("name,kw,with_opacity", PROJ_CASES, ids=[c[0] for c in PROJ_CASES])
def test_projection_matches(scene_pair, name, kw, with_opacity):
    j, p, cam = scene_pair
    jc, pc = jx.RenderConfig(**kw), pt.RenderConfig(**kw)
    cam = jx.Camera(aspect=jc.aspect).framed(j.bounds_min, j.bounds_max)
    cd = cam.camera_data()
    want = jx_project(j.means, j.scales, j.quats, cd, jc,
                      opacities=j.opacities if with_opacity else None)
    got = pt_project(p.means, p.scales, p.quats, camera_tensors(cd, "cpu"), pc,
                     opacities=p.opacities if with_opacity else None)
    for field in PtClip._fields:
        np.testing.assert_allclose(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)),
            rtol=F32_RTOL, atol=F32_ATOL, err_msg=field,
        )
    # The cull is a yes/no decision and must agree exactly.
    np.testing.assert_array_equal(got.cx.numpy() == -128.0, np.asarray(want.cx) == -128.0)


def test_projection_quat_components_entry(scene_pair):
    j, p, cam = scene_pair
    cd = cam.camera_data()
    cfg_j, cfg_p = jx.RenderConfig(screen_size=128), pt.RenderConfig(screen_size=128)
    rng = np.random.default_rng(1)
    q = rng.normal(size=(4, j.padded_count)).astype(np.float32)
    q /= np.linalg.norm(q, axis=0, keepdims=True)
    want = jx_project(j.means, j.scales, None, cd, cfg_j, opacities=j.opacities,
                      quat_components=tuple(q))
    got = pt_project(p.means, p.scales, None, camera_tensors(cd, "cpu"), cfg_p,
                     opacities=p.opacities, quat_components=tuple(torch.from_numpy(q)))
    for field in PtClip._fields:
        np.testing.assert_allclose(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)),
            rtol=F32_RTOL, atol=F32_ATOL, err_msg=field,
        )


def _packer_inputs(n=4099, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *a: rng.uniform(*a, n).astype(np.float32)  # noqa: E731
    edges = np.array([0.0, 1.0, -1.0, 1e-30, 1e30, 0.5, -0.5, 2.0, -2.0, 3e-3, 7.9e6],
                     np.float32)
    return dict(
        cx=np.concatenate([f(-1.2, 1.2), edges]),
        cy=np.concatenate([f(-1.2, 1.2), edges[::-1]]),
        a=np.concatenate([np.exp(f(-8, 18)), np.abs(edges)]).astype(np.float32),
        c=np.concatenate([np.exp(f(-8, 18)), np.abs(edges[::-1])]).astype(np.float32),
        b=np.concatenate([f(-1, 1), edges]),
        colors=np.concatenate([rng.uniform(-0.2, 1.2, (3, n)), np.tile(edges, (3, 1))],
                              axis=1).astype(np.float32),
        opacity=np.concatenate([f(-0.1, 1.1), edges]),
    )


def test_packers_bit_exact():
    d = _packer_inputs()
    # b as a correlation times sqrt(a c), so rho spans [-1, 1] and beyond.
    b = np.clip(d["b"] * np.sqrt(d["a"].astype(np.float64) * d["c"]), -3e38, 3e38).astype(np.float32)
    pairs = [
        (pg.pack_center_u32(T(d["cx"]), T(d["cy"])), jg.pack_center_u32(d["cx"], d["cy"])),
        (pg.pack_conic_u32(T(d["a"]), T(b), T(d["c"])), jg.pack_conic_u32(d["a"], b, d["c"])),
        (pg.pack_rgb_u32(T(d["colors"])), jg.pack_rgb_u32(d["colors"])),
    ]
    rgb = np.asarray(jg.pack_rgb_u32(d["colors"]))
    pairs.append((pg.pack_rgba_u32(T(rgb), T(d["opacity"])), jg.pack_rgba_u32(rgb, d["opacity"])))
    for got, want in pairs:
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(U32(got), np.asarray(want).astype(np.uint32))


def test_conic_unpack_matches():
    d = _packer_inputs(seed=3)
    b = np.clip(d["b"] * np.sqrt(d["a"].astype(np.float64) * d["c"]), -3e38, 3e38).astype(np.float32)
    q = np.asarray(jg.pack_conic_u32(d["a"], b, d["c"]))
    for got, want in zip(pg.unpack_conic_u32(T(q)), jg.unpack_conic_u32(q)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_RTOL, atol=0)


def test_ellipse_rect_overlap_matches():
    rng = np.random.default_rng(5)
    n = 5000
    f = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)  # noqa: E731
    th = f(0, np.pi)
    x0, y0 = f(-1, 1), f(-1, 1)
    args = [f(-1, 1), f(-1, 1), np.cos(th), np.sin(th), f(0.01, 0.5), f(0.01, 0.5),
            x0, y0, x0 + f(0.01, 0.3), y0 + f(0.01, 0.3)]
    want = np.asarray(jg.ellipse_rect_overlap(*args))
    got = pg.ellipse_rect_overlap(*[T(a) for a in args]).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.05 < want.mean() < 0.95  # both outcomes occur


def clip_to_torch(clip) -> PtClip:
    return PtClip(*[T(getattr(clip, f)) for f in PtClip._fields])


RECT_CASES = [
    ("default", dict(screen_size=128), None, {}),
    ("exact-rect-overlap",
     dict(screen_size=128, center_sampled_runs=False, opacity_aware_extents=False), None, {}),
    ("row-band", dict(screen_size=128), (2, 5), {}),
    ("huge-1024", dict(screen_size=1024), None, dict(min_scale=0.3, max_scale=1.6, extent=3.0)),
    ("rect-epan", dict(screen_size=192, screen_height=128, falloff="epanechnikov"), None, {}),
]


@pytest.mark.parametrize("name,kw,band,scene_kw", RECT_CASES, ids=[c[0] for c in RECT_CASES])
def test_rects_row_packs_and_counts_exact(name, kw, band, scene_kw):
    n = 192 if scene_kw else 500
    j, _ = scenes(n, 9 if scene_kw else 2, **scene_kw)
    jc, pc = jx.RenderConfig(**kw), pt.RenderConfig(**kw)
    cam = jx.Camera(aspect=jc.aspect).framed(j.bounds_min, j.bounds_max)
    clip = jx_project(j.means, j.scales, j.quats, cam.camera_data(), jc, opacities=j.opacities)
    want_r = jb.splat_tile_rects(clip, jc, row_band=band)
    got_r = pb.splat_tile_rects(clip_to_torch(clip), pc, row_band=band)
    for f in want_r._fields:
        np.testing.assert_array_equal(getattr(got_r, f).numpy(), np.asarray(getattr(want_r, f)), f)
    want_p = jb.splat_row_packs(clip, want_r, jc)
    got_p = pb.splat_row_packs(clip_to_torch(clip), got_r, pc)
    for g, w in zip(got_p.packs, want_p.packs):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got_p.counts.numpy(), np.asarray(want_p.counts))
    assert int(got_p.counts.sum()) > 0
    if scene_kw:
        # The scene reaches both fallthroughs: rects taller than 8 rows and
        # rects wider than 63 tiles.
        assert (np.asarray(want_r.h) > 8).any() and (np.asarray(want_r.w) > 63).any()


@pytest.mark.parametrize("bits", [19, 24])
def test_quantize_depth_matches(bits):
    z = np.concatenate([np.linspace(-1.5, 1.5, 10001), [-1.0, 1.0, 0.0]]).astype(np.float32)
    want = np.asarray(jb.quantize_depth(z, bits)).astype(np.int64)
    np.testing.assert_array_equal(pb.quantize_depth(T(z), bits).numpy(), want)
