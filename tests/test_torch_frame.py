"""Whole frames of the PyTorch port on the CPU: against the JAX
``Renderer`` (Pallas kernels in interpret mode), against the golden NumPy
oracle, and the port's own copy of that oracle against the JAX one.  Then
the frame-level behaviour of the port alone: capacity management,
multipass rendering, profiling.

Frames use the suite's rule (tests/test_pipeline.py): at most 2% of the
pixels may differ by more than 8 levels."""

import dataclasses
import warnings

import numpy as np
import pytest

import cudagaussianrenderer_torch as pt
import cudagaussianrenderer_tpu as jx
from cudagaussianrenderer_torch import golden as pgold
from cudagaussianrenderer_torch import render as prender
from cudagaussianrenderer_tpu import golden as jgold
from cudagaussianrenderer_tpu import render as jrender

PIX_TOL, BAD_FRAC = 8, 0.02


def image_close(got, want, *, pix_tol=PIX_TOL, frac=BAD_FRAC, msg=""):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    bad = (diff > pix_tol).any(axis=-1).mean()
    assert bad <= frac, f"{msg}: {bad:.4f} of pixels differ by more than {pix_tol}"


FRAME_CASES = [
    ("gaussian", dict(screen_size=128), dict(n=300, seed=2)),
    ("sh3-epanechnikov-lex-keys",
     dict(screen_size=128, falloff="epanechnikov", depth_bits=32), dict(n=300, seed=8, sh=3)),
    ("rect-background", dict(screen_size=192, screen_height=128, background=(1.0, 1.0, 1.0)),
     dict(n=250, seed=6)),
]


@pytest.mark.parametrize("name,cfg_kw,sc", FRAME_CASES, ids=[c[0] for c in FRAME_CASES])
def test_frame_matches_jax_renderer_and_golden(name, cfg_kw, sc):
    jscene = jx.random_scene(sc["n"], seed=sc["seed"], sh_degree=sc.get("sh", 0))
    pscene = pt.random_scene(sc["n"], seed=sc["seed"], sh_degree=sc.get("sh", 0), device="cpu")
    jc, pc = jx.RenderConfig(**cfg_kw), pt.RenderConfig(**cfg_kw)
    cam = jx.Camera(aspect=jc.aspect).framed(jscene.bounds_min, jscene.bounds_max)

    jr = jx.Renderer(jscene, jc)
    want_jax = jr.render(cam)
    pr = pt.Renderer(pscene, pc, device="cpu")
    got = pr.render(cam)
    assert got.shape == want_jax.shape == (pc.screen_h, pc.screen_w, 4)
    assert got.dtype == np.uint8
    assert got[..., 3].max() == 255  # something rendered
    # The same candidates, so the same capacity for the next frame.
    assert pr.last_candidates == jr.last_candidates
    assert pr.capacity == jr.capacity
    image_close(got, want_jax, msg=f"{name} vs JAX")

    want_gold = pgold.golden_render(pgold.scene_to_numpy(pscene), cam.camera_data(), pc)
    image_close(got, want_gold, msg=f"{name} vs golden")
    # The port's copy of the oracle is the JAX package's oracle.
    np.testing.assert_array_equal(
        want_gold, jgold.golden_render(jgold.scene_to_numpy(jscene), cam.camera_data(), jc)
    )


def test_scene_from_numpy_renders_the_jax_scene():
    """A JAX scene carried across with scene_from_numpy renders the same
    frame as the port's own scene of the same seed."""
    jscene = jx.random_scene(200, seed=12, sh_degree=1).pad_to_multiple(256)
    arrays = {f: getattr(jscene, f) for f in ("means", "scales", "quats", "opacities",
                                              "colors", "sh", "sh_degree", "count",
                                              "bounds_min", "bounds_max")}
    arrays = {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in arrays.items()}
    carried = pt.scene_from_numpy(arrays, device="cpu")
    own = pt.random_scene(200, seed=12, sh_degree=1, device="cpu")
    cfg = pt.RenderConfig(screen_size=64)
    cam = pt.Camera(aspect=1.0).framed(own.bounds_min, own.bounds_max)
    a, _ = pt.render_frame(carried, cam.camera_data(), cfg, 4096, device="cpu")
    b, _ = pt.render_frame(own.pad_to_multiple(256), cam.camera_data(), cfg, 4096, device="cpu")
    np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# Capacity management (the port alone; rules shared with the JAX package)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap", [1, 127, 128, 300, 4096, 4097, 1_000_000])
def test_round_capacity_matches_jax(cap):
    # The CPU grain is the JAX package's interpret-mode grain, the card's
    # its TPU grain.
    assert prender.round_capacity(cap, "cpu") == jrender.round_capacity(cap, interpret=True)
    assert prender.round_capacity(cap, "cuda") == jrender.round_capacity(cap, interpret=False)


@pytest.mark.parametrize("cands", [0, 1000, 1 << 17, 3_661_584, 20_000_000])
def test_capacity_bucket_matches_jax(cands):
    assert pt.Renderer._bucket(cands) == jx.Renderer._bucket(cands)
    assert pt.Renderer.MAX_CAPACITY == jx.Renderer.MAX_CAPACITY


@pytest.fixture(scope="module")
def small_scene():
    scene = pt.random_scene(400, seed=9, device="cpu")
    cam = pt.Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    return scene, cam


def test_initial_capacity_rounded_and_clamped(small_scene):
    scene, _ = small_scene
    r = pt.Renderer(scene, pt.RenderConfig(screen_size=128, capacity=300), device="cpu")
    assert r.capacity == 384 and not r.adaptive_capacity
    assert r.scene.padded_count % 4096 == 0
    big = pt.Renderer(scene, pt.RenderConfig(screen_size=128, capacity=1 << 30), device="cpu")
    assert big.capacity == pt.Renderer.MAX_CAPACITY


def test_saturation_doubles_capacity(small_scene):
    scene, cam = small_scene
    r = pt.Renderer(scene, pt.RenderConfig(screen_size=128, capacity=512), device="cpu")
    img = r.render(cam)
    assert r.saturated and r.last_candidates > 512
    assert img[..., 3].max() == 255  # renders, truncated
    cap0 = r.capacity
    r.render(cam)
    assert r.capacity == cap0 * 2  # Demo.cpp:356-366 behaviour


def test_adaptive_capacity_follows_candidates(small_scene):
    scene, cam = small_scene
    r = pt.Renderer(scene, pt.RenderConfig(screen_size=128), device="cpu")
    r.render(cam)
    assert r.adaptive_capacity and not r.saturated
    assert r.capacity == pt.Renderer._bucket(r.last_candidates)
    r.render(cam, check_saturation=False)
    assert r.frame_count == 2


def test_capacity_ceiling_warns_once_and_truncates(small_scene, monkeypatch):
    scene, cam = small_scene
    monkeypatch.setattr(pt.Renderer, "MAX_CAPACITY", 1024)
    r = pt.Renderer(scene, pt.RenderConfig(screen_size=128), device="cpu")
    assert r.capacity == 1024
    with pytest.warns(RuntimeWarning, match="capacity ceiling"):
        img = r.render(cam)
    assert img[..., 3].max() == 255
    assert r.capacity == 1024
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the warning fires once per renderer
        r.render(cam)
    assert r.capacity == 1024


def test_unaligned_capacity_renders(small_scene):
    scene, cam = small_scene
    img, aux = pt.render_frame(scene, cam.camera_data(), pt.RenderConfig(screen_size=128), 300,
                               device="cpu")
    assert img.shape == (128, 128, 4)
    assert int(aux["num_pairs"]) == min(int(aux["num_candidates"]), 384)


def test_multipass_matches_single_pass(small_scene):
    """Four tile-row passes, each below the frame's candidate total, give
    the frame that one pass with room for every pair gives."""
    scene, cam = small_scene
    cfg = pt.RenderConfig(screen_size=128)
    img0, aux0 = pt.render_frame(scene, cam.camera_data(), cfg, 8192, device="cpu")
    total = int(aux0["num_candidates"])
    per_pass = 1024
    assert per_pass < total <= 8192
    img1, aux1 = pt.render_frame_multipass(scene, cam.camera_data(), cfg, per_pass, 4,
                                           device="cpu")
    assert int(aux1["num_candidates"]) == total
    assert int(aux1["num_pairs"]) == total
    np.testing.assert_array_equal(aux1["pass_pairs"].numpy(), aux1["pass_candidates"].numpy())
    d = np.abs(img0.numpy().astype(int) - img1.numpy().astype(int))
    assert (d > 2).any(axis=-1).mean() == 0.0
    with pytest.raises(ValueError):
        pt.render_frame_multipass(scene, cam.camera_data(), cfg, per_pass, 3, device="cpu")


def test_empty_view_renders_black(small_scene):
    scene, _ = small_scene
    cam = pt.Camera(position=np.array([0.0, 0.0, -500.0], np.float32), aspect=1.0)
    img = pt.Renderer(scene, pt.RenderConfig(screen_size=128), device="cpu").render(cam)
    assert img.sum() == 0


def test_zero_opacity_scene_renders_black():
    scene = pt.random_scene(50, seed=1, device="cpu")
    scene = dataclasses.replace(scene, opacities=scene.opacities * 0.0)
    cam = pt.Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    img, aux = pt.render_frame(scene, cam.camera_data(), pt.RenderConfig(screen_size=64), 1024,
                               device="cpu")
    assert int(aux["num_candidates"]) == 0 and int(img.sum()) == 0


def test_profile_frame_and_report(small_scene):
    scene, cam = small_scene
    sh_scene = pt.random_scene(100, seed=3, sh_degree=2, device="cpu")
    for s, has_sh in ((scene, False), (sh_scene, True)):
        r = pt.Renderer(s, pt.RenderConfig(screen_size=64), device="cpu")
        stages = r.profile_frame(cam, warmup=True)
        names = list(prender.STAGE_NAMES if has_sh else prender.STAGE_NAMES[1:])
        assert list(stages) == names
        assert all(v >= 0.0 for v in stages.values())
        assert r.profiled_count == 1
        lines = r.report().splitlines()
        assert [ln.split(" average")[0] for ln in lines] == list(prender.STAGE_NAMES) + ["Total"]
    assert prender.STAGE_NAMES == jrender.STAGE_NAMES
