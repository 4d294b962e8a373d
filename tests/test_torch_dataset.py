"""The port's posed-image datasets (cudagaussianrenderer_torch.dataset): the
counterparts of tests/test_dataset.py's test functions, then parity with
the JAX package's dataset.py on the same cameras and files.

Parity is exact: ``transforms.json`` written by both packages is byte-equal,
and both loaders return equal cameras and bit-equal images from one
directory.  Frames come from the port's Renderer on the CPU."""

import json
import math
import re

import numpy as np
import pytest

import cudagaussianrenderer_tpu.dataset as jdataset
from cudagaussianrenderer_torch import dataset
from cudagaussianrenderer_torch.config import RenderConfig
from cudagaussianrenderer_torch.models.camera import Camera, orbit_cameras, quat_to_matrix
from cudagaussianrenderer_torch.models.scene import random_scene
from cudagaussianrenderer_torch.render import Renderer
from cudagaussianrenderer_torch.utils.png import write_png
from cudagaussianrenderer_tpu.models.camera import Camera as JCamera

from torch_port_cases import fit_outputs_close, one_torch_thread  # noqa: F401 (one_torch_thread: an autouse fixture)


def _random_camera(rng, aspect=1.0):
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    return Camera(
        position=rng.standard_normal(3).astype(np.float32),
        rotation=q.astype(np.float32),
        fov_y=math.radians(rng.uniform(30, 90)),
        aspect=aspect,
    )


def _jax_camera(cam):
    return JCamera(position=cam.position, rotation=cam.rotation, fov_y=cam.fov_y,
                   near=cam.near, far=cam.far, aspect=cam.aspect)


def _assert_cameras_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.position, w.position)
        np.testing.assert_array_equal(g.rotation, w.rotation)
        assert (g.fov_y, g.aspect, g.near, g.far) == (w.fov_y, w.aspect, w.near, w.far)


# --- counterparts of tests/test_dataset.py ---------------------------------


def test_camera_transform_roundtrip():
    rng = np.random.default_rng(3)
    for aspect in (1.0, 16 / 9):
        for _ in range(10):
            cam = _random_camera(rng, aspect)
            m = dataset.camera_to_transform(cam)
            fov_x = 2.0 * math.atan(math.tan(cam.fov_y / 2) * cam.aspect)
            back = dataset.transform_to_camera(m, fov_x, aspect)
            np.testing.assert_allclose(back.position, cam.position, atol=1e-6)
            np.testing.assert_allclose(quat_to_matrix(back.rotation),
                                       quat_to_matrix(cam.rotation), atol=1e-5)
            assert back.fov_y == pytest.approx(cam.fov_y, abs=1e-9)


def test_write_and_load_transforms(tmp_path):
    rng = np.random.default_rng(0)
    cams = [_random_camera(rng) for _ in range(3)]
    names = [f"im_{i}.png" for i in range(3)]
    dataset.write_transforms(tmp_path / "transforms.json", cams, names)
    frames, fov_x, base = dataset.load_transforms(tmp_path)
    assert base == tmp_path and len(frames) == 3
    assert fov_x == pytest.approx(2.0 * math.atan(math.tan(cams[0].fov_y / 2) * cams[0].aspect))
    for (m, rel), cam, name in zip(frames, cams, names):
        assert rel.name == name
        np.testing.assert_allclose(m, dataset.camera_to_transform(cam), atol=1e-12)


def test_load_transforms_blender_quirks(tmp_path):
    doc = {"camera_angle_x": 0.7,
           "frames": [{"file_path": "./train/r_0", "transform_matrix": np.eye(4).tolist()}]}
    (tmp_path / "transforms_train.json").write_text(json.dumps(doc))
    frames, _, _ = dataset.load_transforms(tmp_path)
    assert frames[0][1].suffix == ".png"
    (tmp_path / "bad.json").write_text(json.dumps({"frames": []}))
    with pytest.raises(ValueError, match="camera_angle_x"):
        dataset.load_transforms(tmp_path / "bad.json")


def test_load_dataset_composites_and_downscales(tmp_path):
    img = np.zeros((32, 32, 4), np.uint8)
    img[:, :16] = (255, 0, 0, 255)
    write_png(tmp_path / "f.png", img)
    dataset.write_transforms(tmp_path / "transforms.json", [Camera(aspect=1.0)], ["f.png"])
    cams, images = dataset.load_dataset(tmp_path, background=(0, 0, 1))
    assert images.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(images[0, 0, 0], [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(images[0, 0, -1], [0, 0, 1], atol=1e-6)
    assert cams[0].aspect == 1.0
    _, small = dataset.load_dataset(tmp_path, downscale=2)
    assert small.shape == (1, 16, 16, 3)
    np.testing.assert_allclose(small[0, 0, 0], [1, 0, 0], atol=1e-6)
    with pytest.raises(ValueError, match="divisible"):
        dataset.load_dataset(tmp_path, downscale=3)


def test_init_bounds_from_cameras():
    cams = orbit_cameras(np.array([-1.0, -1, -1], np.float32), np.array([1.0, 1, 1], np.float32), 8)
    lo, hi = dataset.init_bounds_from_cameras(cams)
    pos = np.stack([c.position for c in cams])
    center = pos.mean(axis=0)
    radius = np.linalg.norm(pos - center, axis=1).mean()
    np.testing.assert_allclose((lo + hi) / 2, center, atol=1e-5)
    np.testing.assert_allclose(hi - lo, 2 * 0.4 * radius, rtol=1e-5)
    jlo, jhi = jdataset.init_bounds_from_cameras([_jax_camera(c) for c in cams])
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)


def test_export_then_load_roundtrip(tmp_path):
    """export_dataset (the port's Renderer on the CPU) writes frames the
    loader reproduces exactly."""
    scene = random_scene(100, seed=1, device="cpu")
    renderer = Renderer(scene, RenderConfig(screen_size=32), device="cpu")
    cams = orbit_cameras(scene.bounds_min, scene.bounds_max, 2)
    tpath = dataset.export_dataset(tmp_path / "ds", renderer, cams)
    assert tpath.exists()
    got_cams, images = dataset.load_dataset(tmp_path / "ds")
    assert images.shape == (2, 32, 32, 3)
    for got, want in zip(got_cams, cams):
        np.testing.assert_allclose(got.position, want.position, atol=1e-6)
        np.testing.assert_allclose(quat_to_matrix(got.rotation), quat_to_matrix(want.rotation),
                                   atol=1e-5)
    want_img = renderer.render(cams[0]).astype(np.float32) / 255.0
    a = want_img[..., 3:4]
    np.testing.assert_allclose(images[0], want_img[..., :3] * a, atol=1 / 255 + 1e-6)
    # The JAX loader reads the port's export to the same arrays.
    jcams, jimages = jdataset.load_dataset(tmp_path / "ds")
    np.testing.assert_array_equal(images, jimages)
    _assert_cameras_equal(got_cams, jcams)


def test_cli_orbit_dataset_then_fit_refuses(tmp_path, capsys):
    """orbit --transforms exports a dataset that load_posed reads back; fit
    --dataset with --holdout and --eval-dataset (tests/test_dataset.py's
    test_cli_fit_from_dataset, tests/test_cli_and_profile.py's
    test_cli_eval_and_holdout) trains on it as the JAX CLI does with the
    same arguments (fit_outputs_close); --init points refuses in both, the
    layout having no SfM point cloud."""
    from cudagaussianrenderer_torch.cli import main
    from cudagaussianrenderer_tpu.cli import main as jmain

    ds = tmp_path / "ds"
    main(["orbit", "--procedural", "60", "--seed", "3", "--size", "32", "-o", str(ds), "-n", "4",
          "--transforms", "--device", "cpu"])
    posed = dataset.load_posed(ds)
    assert posed.images.shape == (4, 32, 32, 3) and posed.names[:2] == ["frame_0000.png",
                                                                         "frame_0001.png"]
    fit = ["fit", "--dataset", str(ds), "--splats", "20", "--steps", "2", "--k-max", "64",
           "--holdout", "4", "--eval-dataset", str(ds)]
    for run, flags in ((jmain, []), (main, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match="no SfM point cloud"):
            run([*fit, "--init", "points", "-o", str(tmp_path / "x.ply"), *flags])
    capsys.readouterr()
    jmain([*fit, "-o", str(tmp_path / "jax.ply")])
    want = capsys.readouterr().err
    main([*fit, "-o", str(tmp_path / "port.ply"), "--device", "cpu"])
    got = capsys.readouterr().err
    assert "holdout: 1 test / 3 train views" in got
    assert re.search(r"holdout eval \(every 4th view\) \(1 views\): PSNR", got)
    assert re.search(r"\beval \(4 views\): PSNR", got)
    fit_outputs_close(got, want, tmp_path / "port.ply", tmp_path / "jax.ply", posed.cameras[1])
    assert not (tmp_path / "x.ply").exists()


# --- parity with the JAX package ---------------------------------------------


@pytest.mark.parametrize("aspect", [1.0, 16 / 9])
def test_transforms_json_byte_equal_to_jax(tmp_path, aspect):
    rng = np.random.default_rng(11)
    cams = [_random_camera(rng, aspect) for _ in range(4)]
    names = [f"images/v_{i}.png" for i in range(4)]
    dataset.write_transforms(tmp_path / "port.json", cams, names)
    jdataset.write_transforms(tmp_path / "jax.json", [_jax_camera(c) for c in cams], names)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    for c in cams:
        np.testing.assert_array_equal(dataset.camera_to_transform(c),
                                      jdataset.camera_to_transform(_jax_camera(c)))


@pytest.mark.parametrize("background", [None, (1.0, 1.0, 1.0)])
@pytest.mark.parametrize("downscale", [1, 2])
def test_load_posed_equals_jax(tmp_path, background, downscale):
    rng = np.random.default_rng(5)
    cams = [_random_camera(rng, 1.5) for _ in range(3)]
    for i in range(3):
        write_png(tmp_path / f"im_{i}.png", rng.integers(0, 256, (16, 24, 4), dtype=np.uint8))
    dataset.write_transforms(tmp_path / "transforms.json", cams, [f"im_{i}.png" for i in range(3)])
    got = dataset.load_posed(tmp_path, downscale=downscale, background=background, max_frames=2)
    want = jdataset.load_posed(tmp_path, downscale=downscale, background=background,
                               max_frames=2)
    _assert_cameras_equal(got.cameras, want.cameras)
    np.testing.assert_array_equal(got.images, want.images)
    assert got.images.dtype == want.images.dtype
    assert got.names == want.names
    np.testing.assert_array_equal(got.points_xyz, want.points_xyz)
