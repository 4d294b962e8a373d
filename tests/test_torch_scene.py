"""The PyTorch port's configuration, scene, camera and packaging against
the JAX package: for the same seed and camera both packages hold the same
bits, and the port stands alone (no jax, no JAX package) and runs on the
card unless the caller asks for the CPU."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cudagaussianrenderer_torch as pt
import cudagaussianrenderer_tpu as jx
from cudagaussianrenderer_torch.golden import scene_to_numpy as pt_scene_to_numpy
from cudagaussianrenderer_torch.utils import quantize as pt_quantize
from cudagaussianrenderer_tpu.golden import scene_to_numpy as jx_scene_to_numpy
from cudagaussianrenderer_tpu.utils import quantize as jx_quantize

ROOT = Path(__file__).resolve().parent.parent


def jax_scene_arrays(scene) -> dict:
    """The planar numpy arrays of a JAX GaussianScene, as scene_from_numpy
    takes them."""
    return dict(
        means=np.asarray(scene.means),
        scales=np.asarray(scene.scales),
        quats=np.asarray(scene.quats),
        opacities=np.asarray(scene.opacities),
        colors=np.asarray(scene.colors),
        sh=None if scene.sh is None else np.asarray(scene.sh),
        sh_degree=scene.sh_degree,
        count=scene.count,
        bounds_min=scene.bounds_min,
        bounds_max=scene.bounds_max,
    )


def assert_scene_bits_equal(port, ref: dict):
    """Every array of the port's scene equals the reference arrays bit for
    bit (quats compared as uint32 words), and the metadata matches."""
    for name in ("means", "scales", "opacities", "colors"):
        got = getattr(port, name).cpu().numpy()
        assert got.dtype == np.float32, name
        np.testing.assert_array_equal(got.view(np.uint32), ref[name].view(np.uint32), name)
    np.testing.assert_array_equal(port.quats.cpu().numpy().view(np.uint32), ref["quats"])
    if ref["sh"] is None:
        assert port.sh is None
    else:
        np.testing.assert_array_equal(
            port.sh.cpu().numpy().view(np.uint32), ref["sh"].view(np.uint32)
        )
    assert port.sh_degree == ref["sh_degree"]
    assert port.count == ref["count"]
    assert port.bounds_min == tuple(ref["bounds_min"])
    assert port.bounds_max == tuple(ref["bounds_max"])


CONFIGS = [
    {},
    dict(screen_size=128),
    dict(screen_size=192, screen_height=128, falloff="epanechnikov"),
    dict(screen_size=2048),  # > 8191 tiles: auto-switch to depth_bits=32
    dict(screen_size=256, tiles_per_cell=4, raster_chunk=256, background=(1, 0.5, 0)),
    dict(screen_size=512, capacity=5000, depth_bits=32, gamma=2.2),
]


@pytest.mark.parametrize("kwargs", CONFIGS)
def test_config_fields_and_derived_properties_match(kwargs):
    a = pt.RenderConfig(**kwargs)
    b = jx.RenderConfig(**kwargs)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for prop in ("screen_w", "screen_h", "aspect", "tiles_x", "tiles_y",
                 "tiles_per_screen", "total_tiles", "pixels_per_tile",
                 "sigma_factor", "sentinel_tile"):
        assert getattr(a, prop) == getattr(b, prop), prop
    assert a.cell_tiles() == b.cell_tiles()
    for n in (1, 500, 4096, 1_000_000):
        assert a.tile_capacity(n) == b.tile_capacity(n)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(screen_size=100),
        dict(screen_size=128, screen_height=100),
        dict(screen_size=4096),           # 256 tiles per axis
        dict(falloff="box"),
        dict(background=(1.0, 2.0, 0.0)),
        dict(depth_bits=24),
        dict(raster_chunk=192),
        dict(raster_chunk=64),
        dict(screen_size=128, tiles_per_cell=3),
        dict(screen_size=128, sort_bands=9),
    ],
)
def test_config_validation_matches(kwargs):
    with pytest.raises(ValueError):
        jx.RenderConfig(**kwargs)
    with pytest.raises(ValueError):
        pt.RenderConfig(**kwargs)


def test_camera_defaults_match():
    from cudagaussianrenderer_torch import config as pc
    from cudagaussianrenderer_tpu import config as jc

    assert (pc.DEFAULT_NEAR, pc.DEFAULT_FAR, pc.DEFAULT_FOV_Y_DEG) == (
        jc.DEFAULT_NEAR, jc.DEFAULT_FAR, jc.DEFAULT_FOV_Y_DEG
    )


@pytest.mark.parametrize("sh_degree", [0, 3])
def test_random_scene_bit_exact(sh_degree):
    ref = jx.random_scene(300, seed=7, sh_degree=sh_degree, min_scale=0.02)
    got = pt.random_scene(300, seed=7, sh_degree=sh_degree, min_scale=0.02, device="cpu")
    assert_scene_bits_equal(got, jax_scene_arrays(ref))
    # Padding adds the same inert splats.
    assert_scene_bits_equal(got.pad_to_multiple(256), jax_scene_arrays(ref.pad_to_multiple(256)))


def test_scene_from_arrays_bit_exact():
    rng = np.random.default_rng(3)
    n = 50
    args = (
        rng.normal(size=(n, 3)).astype(np.float32),
        rng.uniform(0.01, 0.2, (n, 3)).astype(np.float32),
        rng.normal(size=(n, 4)).astype(np.float32),
        rng.uniform(0, 1, n).astype(np.float32),
        rng.uniform(0, 1, (n, 3)).astype(np.float32),
        rng.normal(size=(n, 4, 3)).astype(np.float32),
        1,
    )
    ref = jx.scene_from_arrays(*args)
    got = pt.scene_from_arrays(*args, device="cpu")
    assert_scene_bits_equal(got, jax_scene_arrays(ref))


@pytest.mark.parametrize("sh_degree", [0, 2])
def test_scene_from_numpy_round_trip(sh_degree):
    ref = jx.random_scene(200, seed=11, sh_degree=sh_degree).pad_to_multiple(256)
    arrays = jax_scene_arrays(ref)
    got = pt.scene_from_numpy(arrays, device="cpu")
    assert got.padded_count == 256
    assert_scene_bits_equal(got, arrays)
    # Both oracles' host views of the scene agree too.
    a, b = pt_scene_to_numpy(got), jx_scene_to_numpy(ref)
    assert a.keys() == b.keys()
    for k in a:
        if a[k] is None or np.isscalar(a[k]) or isinstance(a[k], (int, tuple)):
            assert a[k] == b[k], k
        else:
            np.testing.assert_array_equal(a[k], b[k], k)


def test_camera_data_bit_exact():
    bmin, bmax = (-4.0, -3.0, -2.0), (4.0, 5.0, 2.5)
    cams = [
        (pt.Camera(aspect=1.5).framed(bmin, bmax), jx.Camera(aspect=1.5).framed(bmin, bmax)),
        *zip(pt.orbit_cameras(bmin, bmax, 5), jx.orbit_cameras(bmin, bmax, 5)),
    ]
    for a, b in cams:
        da, db = a.camera_data(), b.camera_data()
        assert da.keys() == db.keys()
        for k in da:
            x, y = np.asarray(da[k]), np.asarray(db[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, k)


def test_camera_controller_matches():
    a = pt.CameraController((128.0, 128.0))
    b = jx.CameraController((128.0, 128.0))
    a.set_bounds((-1, -1, -1), (1, 1, 1))
    b.set_bounds((-1, -1, -1), (1, 1, 1))
    steps = [
        dict(pointer=(64.0, 64.0)),
        dict(pointer=(70.0, 60.0), buttons="left"),
        dict(pointer=(50.0, 66.0), buttons="middle"),
        dict(pointer=(40.0, 70.0), buttons="middle"),
        dict(pointer=(40.0, 70.0), buttons="right"),
        dict(pointer=(44.0, 72.0), buttons="right", move=(0.3, -0.2, 1.0)),
    ]
    for kw in steps:
        ca = a.update(pt.InputState(**kw), 0.016)
        cb = b.update(jx.InputState(**kw), 0.016)
        np.testing.assert_array_equal(ca.view(), cb.view())


def test_quantize_matches():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(257, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    packed = pt_quantize.encode_quat_xyzw(q)
    np.testing.assert_array_equal(packed, jx_quantize.encode_quat_xyzw(q))
    np.testing.assert_array_equal(
        pt_quantize.decode_quat_xyzw(packed), jx_quantize.decode_quat_xyzw(packed)
    )
    ref = jx_quantize.decode_quat_components(packed)
    for got in (
        pt_quantize.decode_quat_components(packed),
        pt_quantize.decode_quat_components(torch.from_numpy(packed.view(np.int32))),
    ):
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, cudagaussianrenderer_torch, cudagaussianrenderer_torch.golden\n"
        "import cudagaussianrenderer_torch.render, cudagaussianrenderer_torch.utils.cuda_build\n"
        "import cudagaussianrenderer_torch.ops.banded\n"
        "import cudagaussianrenderer_torch.tools.bench_suite, cudagaussianrenderer_torch.tools.fit_artifact\n"
        "import cudagaussianrenderer_torch.tools.make_artifact\n"
        "import cudagaussianrenderer_torch.tools.measure, cudagaussianrenderer_torch.tools.selfcheck\n"
        "import cudagaussianrenderer_torch.tools.smoke_batch\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', "
        "'cudagaussianrenderer_tpu', 'tools.')) or m in ('tools', 'bench_suite', 'fit_artifact', "
        "'make_artifact', 'sh_codegen', 'measure', 'smoke_batch', 'tpu_selfcheck'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_chip_smoke_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    assert "import jax" not in src and "cudagaussianrenderer_tpu" not in src.replace(
        '"cudagaussianrenderer_tpu/', ""
    )


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = pt.RenderConfig(screen_size=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.random_scene(10, seed=0)
    scene = pt.random_scene(10, seed=0, device="cpu")
    cam = pt.Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.Renderer(scene, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.render_frame(scene, cam.camera_data(), cfg, 1024)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.render_frame_multipass(scene, cam.camera_data(), cfg, 1024, 2)
    image = pt.Renderer(scene, cfg, device="cpu").render(cam)
    assert image.shape == (64, 64, 4) and image.dtype == np.uint8


@pytest.mark.parametrize("tool,argv", [
    ("bench_suite", ["1", "--n-scale", "0.002", "--size-scale", "0.25", "--frames-scale", "0.125"]),
    ("fit_artifact", ["--scene-splats", "50", "--fit-splats", "50", "--views", "1",
                      "--size", "32", "--steps", "1"]),
    ("make_artifact", ["--n", "50", "--size", "32", "--frames", "1"]),
])
def test_tools_need_cuda_unless_cpu(tool, argv, tmp_path, monkeypatch):
    """Each of the port's tools raises without a card, and runs with
    ``--device cpu``."""
    import importlib

    mod = importlib.import_module(f"cudagaussianrenderer_torch.tools.{tool}")
    if tool != "bench_suite":
        argv = argv + ["--out", str(tmp_path)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(argv)
    assert mod.main(argv + ["--device", "cpu"])


def test_banded_path_renders_on_cpu():
    """Once the place where ``sort_bands > 1`` raised NotImplementedError;
    the banded path is ported, so both entry points now render."""
    scene = pt.random_scene(10, seed=0, device="cpu")
    cfg = pt.RenderConfig(screen_size=128, sort_bands=4)
    cam = pt.Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    image = pt.Renderer(scene, cfg, device="cpu").render(cam)
    frame, aux = pt.render_frame(scene, cam.camera_data(), cfg, 1024, device="cpu")
    assert image.shape == tuple(frame.shape) == (128, 128, 4)
    assert aux["band_totals"].shape == aux["band_splats"].shape == (4,)
