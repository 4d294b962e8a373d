"""The port's COLMAP reader and writer (cudagaussianrenderer_torch.colmap): the
counterparts of tests/test_colmap.py's test functions, then parity with the
JAX package's colmap.py.

Parity is exact: the ``.bin`` files both packages write from the same
records are byte-equal, and both read the same model, text or binary, and
the same dataset to equal cameras and bit-equal images and points.  ``fit
--dataset`` of a workspace is held against the JAX CLI's; the splat
initialisation from the SfM points (diff.init_from_points) is held against
the JAX package's in tests/test_torch_diff_structure.py."""

import math
import struct

import numpy as np
import pytest

import cudagaussianrenderer_tpu.colmap as jcolmap
from cudagaussianrenderer_torch import colmap, dataset
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
    return Camera(position=rng.standard_normal(3).astype(np.float32),
                  rotation=q.astype(np.float32),
                  fov_y=math.radians(rng.uniform(30, 90)), aspect=aspect)


def _jax_camera(cam):
    return JCamera(position=cam.position, rotation=cam.rotation, fov_y=cam.fov_y,
                   near=cam.near, far=cam.far, aspect=cam.aspect)


def _write_txt_model(sparse, cams, images, xyz, rgb):
    lines = ["# cameras"]
    for c in cams:
        lines.append(f"{c.camera_id} {c.model} {c.width} {c.height} "
                     + " ".join(repr(float(p)) for p in c.params))
    (sparse / "cameras.txt").write_text("\n".join(lines) + "\n")
    lines = ["# images"]
    for im in images:
        lines.append(" ".join([str(im.image_id)] + [repr(float(v)) for v in im.qvec]
                              + [repr(float(v)) for v in im.tvec] + [str(im.camera_id), im.name]))
        lines.append("")  # empty 2D-observations line
    (sparse / "images.txt").write_text("\n".join(lines) + "\n")
    lines = ["# points"]
    rgb8 = (np.asarray(rgb) * 255 + 0.5).astype(int)
    for i, (p, c) in enumerate(zip(xyz, rgb8)):
        lines.append(" ".join([str(i + 1)] + [repr(float(v)) for v in p]
                              + [str(int(v)) for v in c] + ["0.5"]))
    (sparse / "points3D.txt").write_text("\n".join(lines) + "\n")


def _records(seed=0, n_images=3):
    rng = np.random.default_rng(seed)
    cams = [colmap.ColmapCamera(1, "PINHOLE", 640, 480, np.array([500.0, 510.0, 320.0, 240.0])),
            colmap.ColmapCamera(2, "SIMPLE_PINHOLE", 64, 64, np.array([80.0, 32.0, 32.0]))]
    images = [colmap.ColmapImage(i + 1, rng.standard_normal(4), rng.standard_normal(3),
                                 1 + (i % 2), f"sub/frame_{i:03d}.jpg") for i in range(n_images)]
    xyz = rng.standard_normal((5, 3)).astype(np.float32)
    rgb = rng.uniform(0, 1, (5, 3)).astype(np.float32)
    return cams, images, xyz, rgb


def _assert_cameras_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.position, w.position)
        np.testing.assert_array_equal(g.rotation, w.rotation)
        assert (g.fov_y, g.aspect) == (w.fov_y, w.aspect)


def _rendered_workspace(root, n_views=3, size=32):
    scene = random_scene(100, seed=1, device="cpu")
    renderer = Renderer(scene, RenderConfig(screen_size=size), device="cpu")
    cams = orbit_cameras(scene.bounds_min, scene.bounds_max, n_views)
    (root / "images").mkdir(parents=True)
    names = []
    for i, cam in enumerate(cams):
        names.append(f"frame_{i:04d}.png")
        write_png(root / "images" / names[-1], renderer.render(cam))
    return scene, renderer, cams, names


# --- counterparts of tests/test_colmap.py ------------------------------------


def test_bin_roundtrip(tmp_path):
    cams, images, xyz, rgb = _records()
    colmap.write_cameras_bin(tmp_path / "cameras.bin", cams)
    colmap.write_images_bin(tmp_path / "images.bin", images)
    colmap.write_points3d_bin(tmp_path / "points3D.bin", xyz, rgb)
    got_cams = colmap.read_cameras_bin(tmp_path / "cameras.bin")
    assert set(got_cams) == {1, 2}
    for want in cams:
        got = got_cams[want.camera_id]
        assert (got.model, got.width, got.height) == (want.model, want.width, want.height)
        np.testing.assert_array_equal(got.params, want.params)
    for got, want in zip(colmap.read_images_bin(tmp_path / "images.bin"), images):
        assert (got.image_id, got.camera_id, got.name) == (want.image_id, want.camera_id,
                                                           want.name)
        np.testing.assert_array_equal(got.qvec, want.qvec)
        np.testing.assert_array_equal(got.tvec, want.tvec)
    got_xyz, got_rgb = colmap.read_points3d_bin(tmp_path / "points3D.bin")
    np.testing.assert_allclose(got_xyz, xyz, atol=1e-6)
    np.testing.assert_allclose(got_rgb, rgb, atol=0.5 / 255)


def test_images_bin_skips_observations(tmp_path):
    with open(tmp_path / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<i", 7))
        f.write(struct.pack("<dddd", 1.0, 0.0, 0.0, 0.0))
        f.write(struct.pack("<ddd", 0.5, -1.0, 2.0))
        f.write(struct.pack("<i", 3))
        f.write(b"a.png\x00")
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<ddq", 1.0, 2.0, -1))
        f.write(struct.pack("<ddq", 3.0, 4.0, 11))
    (img,) = colmap.read_images_bin(tmp_path / "images.bin")
    assert (img.image_id, img.camera_id, img.name) == (7, 3, "a.png")
    np.testing.assert_array_equal(img.tvec, [0.5, -1.0, 2.0])


def test_txt_bin_parity(tmp_path):
    cams, images, xyz, rgb = _records(seed=1, n_images=2)
    cams = cams[:1]
    images = [im._replace(camera_id=1, name=f"v_{i}.png") for i, im in enumerate(images)]
    bdir, tdir = tmp_path / "bin", tmp_path / "txt"
    bdir.mkdir()
    tdir.mkdir()
    colmap.write_cameras_bin(bdir / "cameras.bin", cams)
    colmap.write_images_bin(bdir / "images.bin", images)
    colmap.write_points3d_bin(bdir / "points3D.bin", xyz, rgb)
    _write_txt_model(tdir, cams, images, xyz, rgb)
    mb, mt = colmap.load_model(bdir), colmap.load_model(tdir)
    assert set(mb.cameras) == set(mt.cameras)
    for cid in mb.cameras:
        np.testing.assert_allclose(mb.cameras[cid].params, mt.cameras[cid].params, rtol=1e-15)
    assert [i.name for i in mb.images] == [i.name for i in mt.images]
    for a, b in zip(mb.images, mt.images):
        np.testing.assert_allclose(a.qvec, b.qvec, rtol=1e-15)
        np.testing.assert_allclose(a.tvec, b.tvec, rtol=1e-15)
    np.testing.assert_allclose(mb.points_xyz, mt.points_xyz, atol=1e-6)
    np.testing.assert_allclose(mb.points_rgb, mt.points_rgb, atol=0.5 / 255)


def test_pose_roundtrip_and_view_matrix():
    rng = np.random.default_rng(2)
    intr = colmap.ColmapCamera(1, "PINHOLE", 640, 480, np.array([400.0, 400.0, 320.0, 240.0]))
    for _ in range(10):
        cam = _random_camera(rng, aspect=640 / 480)
        cam = Camera(position=cam.position, rotation=cam.rotation,
                     fov_y=2.0 * math.atan(480 / (2 * 400.0)), aspect=640 / 480)
        qvec, tvec = colmap.camera_to_pose(cam)
        back = colmap.pose_to_camera(colmap.ColmapImage(1, qvec, tvec, 1, "x.png"), intr)
        np.testing.assert_allclose(back.position, cam.position, atol=1e-5)
        np.testing.assert_allclose(quat_to_matrix(back.rotation), quat_to_matrix(cam.rotation),
                                   atol=1e-5)
        assert back.fov_y == pytest.approx(cam.fov_y, abs=1e-6)
        assert back.aspect == pytest.approx(cam.aspect)
        r_w2c = colmap.qvec_to_rotmat(qvec)
        world = r_w2c.T @ np.array([0.0, 0.0, 3.0]) + (-r_w2c.T @ np.asarray(tvec))
        view = back.view() @ np.append(world, 1.0)
        np.testing.assert_allclose(view[:3], [0, 0, -3.0], atol=1e-4)
        # The same pose algebra as the JAX package, bit for bit.
        jq, jt = jcolmap.camera_to_pose(_jax_camera(cam))
        np.testing.assert_array_equal(qvec, jq)
        np.testing.assert_array_equal(tvec, jt)


def test_pose_to_camera_rejects_distortion():
    intr = colmap.ColmapCamera(1, "SIMPLE_RADIAL", 64, 64, np.array([80.0, 32.0, 32.0, 0.1]))
    img = colmap.ColmapImage(1, np.array([1.0, 0, 0, 0]), np.zeros(3), 1, "a.png")
    with pytest.raises(colmap.ColmapError, match="image_undistorter"):
        colmap.pose_to_camera(img, intr)


def test_export_then_load_dataset(tmp_path):
    root = tmp_path / "ws"
    scene, renderer, cams, names = _rendered_workspace(root)
    xyz = scene.means.numpy().T[:50].astype(np.float32)
    rgb = np.full((50, 3), 0.5, np.float32)
    sparse = colmap.export_model(root, cams, names, 32, 32, xyz, rgb)
    assert (sparse / "cameras.bin").exists()
    assert colmap.find_sparse_dir(root) == sparse
    got_cams, images, pxyz, prgb, got_names = colmap.load_dataset(root)
    assert images.shape == (3, 32, 32, 3) and got_names == names
    np.testing.assert_allclose(pxyz, xyz, atol=1e-6)
    for got, want in zip(got_cams, cams):
        np.testing.assert_allclose(got.position, want.position, atol=1e-5)
        np.testing.assert_allclose(quat_to_matrix(got.rotation), quat_to_matrix(want.rotation),
                                   atol=1e-5)
    want_img = renderer.render(cams[0]).astype(np.float32) / 255.0
    np.testing.assert_allclose(images[0], want_img[..., :3] * want_img[..., 3:4],
                               atol=1 / 255 + 1e-6)
    ds = dataset.load_posed(root)
    assert ds.points_xyz.shape == (50, 3) and ds.images.shape == (3, 32, 32, 3)


def test_load_posed_transforms_fallback(tmp_path):
    rng = np.random.default_rng(0)
    cams = [_random_camera(rng) for _ in range(2)]
    img = rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)
    for i in range(2):
        write_png(tmp_path / f"im_{i}.png", img)
    dataset.write_transforms(tmp_path / "transforms.json", cams, ["im_0.png", "im_1.png"])
    ds = dataset.load_posed(tmp_path)
    assert ds.points_xyz.shape == (0, 3) and ds.images.shape == (2, 8, 8, 3)


def test_sfm_points_for_init_match_jax(tmp_path):
    """The SfM cloud that feeds diff.init_from_points (the hand-computable
    four points of test_init_from_points, whose counterpart is in
    tests/test_torch_diff_structure.py) loads as the JAX package loads it."""
    xyz = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0], [10, 0, 0]], np.float32)
    rgb = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1]], np.float32)
    colmap.export_model(tmp_path, [Camera(aspect=1.0)], ["a.png"], 8, 8, xyz, rgb)
    got = colmap.load_model(tmp_path)
    want = jcolmap.load_model(tmp_path)
    np.testing.assert_array_equal(got.points_xyz, xyz)
    np.testing.assert_array_equal(got.points_rgb, rgb)
    np.testing.assert_array_equal(got.points_xyz, want.points_xyz)
    np.testing.assert_array_equal(got.points_rgb, want.points_rgb)


def test_cli_fit_from_colmap_refuses(tmp_path, capsys):
    """fit --dataset of a COLMAP workspace (tests/test_colmap.py's
    test_cli_fit_from_colmap): one splat per SfM point, --sh-degree reaching
    the fitted model, as the JAX CLI with the same arguments
    (fit_outputs_close); --holdout 1 refuses in both."""
    from cudagaussianrenderer_torch.cli import main
    from cudagaussianrenderer_torch.splatfile import load_scene
    from cudagaussianrenderer_tpu.cli import main as jmain

    root = tmp_path / "ws"
    scene, _, cams, names = _rendered_workspace(root, n_views=2)
    colmap.export_model(root, cams, names, 32, 32,
                        scene.means.numpy().T[: scene.count].astype(np.float32),
                        np.full((scene.count, 3), 0.5, np.float32))
    fit = ["fit", "--dataset", str(root), "--steps", "2", "--k-max", "64", "--sh-degree", "1"]
    for run, flags in ((jmain, []), (main, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match="--holdout takes K >= 2"):
            run([*fit, "--holdout", "1", "-o", str(tmp_path / "x.ply"), *flags])
    capsys.readouterr()
    jmain([*fit, "-o", str(tmp_path / "jax.ply")])
    want = capsys.readouterr().err
    main([*fit, "-o", str(tmp_path / "port.ply"), "--device", "cpu"])
    got = capsys.readouterr().err
    assert "SfM point" in got and "100 splats from the SfM point cloud" in got
    fitted = load_scene(tmp_path / "port.ply", device="cpu")
    assert fitted.count == scene.count and fitted.sh_degree == 1
    fit_outputs_close(got, want, tmp_path / "port.ply", tmp_path / "jax.ply", cams[0])
    assert not (tmp_path / "x.ply").exists()


def test_cli_orbit_colmap_then_fit(tmp_path, capsys):
    """tests/test_colmap.py's test_cli_orbit_colmap_roundtrip: orbit --colmap
    writes a workspace that fit --dataset takes with the point-cloud init."""
    from cudagaussianrenderer_torch.cli import main

    ws = tmp_path / "ws"
    main(["orbit", "--procedural", "50", "--size", "32", "-o", str(ws), "-n", "2", "--colmap",
          "--device", "cpu"])
    assert (ws / "sparse" / "0" / "cameras.bin").exists()
    assert (ws / "images" / "frame_0000.png").exists()
    main(["fit", "--dataset", str(ws), "-o", str(tmp_path / "f.ply"), "--steps", "1",
          "--k-max", "64", "--device", "cpu"])
    err = capsys.readouterr().err
    assert "SfM point" in err and (tmp_path / "f.ply").exists()


def test_pinhole_anisotropic_focal_aspect():
    intr = colmap.ColmapCamera(1, "PINHOLE", 640, 480, np.array([300.0, 400.0, 320.0, 240.0]))
    cam = colmap.pose_to_camera(
        colmap.ColmapImage(1, np.array([1.0, 0, 0, 0]), np.zeros(3), 1, "a.png"), intr)
    assert cam.fov_y == pytest.approx(2 * math.atan(480 / (2 * 400.0)))
    assert cam.aspect == pytest.approx((640 * 400.0) / (480 * 300.0))
    assert 1.0 / math.tan(cam.fov_y / 2) / cam.aspect == pytest.approx(2 * 300.0 / 640)


def test_images_txt_names_with_spaces(tmp_path):
    (tmp_path / "images.txt").write_text(
        "# comment\n1 1.0 0.0 0.0 0.0 0.5 0.5 0.5 1 my photo 01.jpg\n\n")
    (img,) = colmap.read_images_txt(tmp_path / "images.txt")
    assert img.name == "my photo 01.jpg"


def test_grayscale_jpeg_loads(tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image

    rng = np.random.default_rng(0)
    root = tmp_path / "ws"
    (root / "images").mkdir(parents=True)
    Image.fromarray(rng.integers(0, 255, (16, 16), dtype=np.uint8), mode="L").save(
        root / "images" / "g.jpg")
    colmap.export_model(root, [Camera(aspect=1.0)], ["g.jpg"], 16, 16)
    cams, images, _, _, names = colmap.load_dataset(root, downscale=2)
    assert images.shape == (1, 8, 8, 3) and names == ["g.jpg"]
    np.testing.assert_array_equal(images[0, ..., 0], images[0, ..., 1])
    np.testing.assert_array_equal(images, jcolmap.load_dataset(root, downscale=2)[1])


def test_truncated_bin_files_raise_colmap_error(tmp_path):
    colmap.write_cameras_bin(tmp_path / "cameras.bin", [
        colmap.ColmapCamera(1, "PINHOLE", 8, 8, np.array([8.0, 8.0, 4.0, 4.0]))])
    colmap.write_images_bin(tmp_path / "images.bin", [
        colmap.ColmapImage(1, np.array([1.0, 0, 0, 0]), np.zeros(3), 1, "a.png")])
    colmap.write_points3d_bin(tmp_path / "points3D.bin", np.zeros((2, 3), np.float32),
                              np.zeros((2, 3), np.float32))
    for name, reader in (("cameras.bin", colmap.read_cameras_bin),
                         ("images.bin", colmap.read_images_bin),
                         ("points3D.bin", colmap.read_points3d_bin)):
        data = (tmp_path / name).read_bytes()
        for cut in (1, len(data) // 2, len(data) - 1):
            p = tmp_path / f"cut_{name}"
            p.write_bytes(data[:cut])
            with pytest.raises(colmap.ColmapError):
                reader(p)


def test_cli_orbit_colmap_roundtrip(tmp_path):
    """orbit --colmap writes a workspace that load_posed reads back to the
    orbit's cameras and the scene's splat centres as its SfM points."""
    from cudagaussianrenderer_torch.cli import main

    ws = tmp_path / "ws"
    main(["orbit", "--procedural", "50", "--size", "32", "-o", str(ws), "-n", "2", "--colmap",
          "--device", "cpu"])
    assert (ws / "sparse" / "0" / "cameras.bin").exists()
    assert (ws / "images" / "frame_0000.png").exists()
    ds = dataset.load_posed(ws)
    scene = random_scene(50, seed=0, device="cpu")
    cams = orbit_cameras(scene.bounds_min, scene.bounds_max, 2)
    assert ds.images.shape == (2, 32, 32, 3) and ds.points_xyz.shape == (50, 3)
    np.testing.assert_array_equal(ds.points_xyz, scene.means.numpy().T)
    for got, want in zip(ds.cameras, cams):
        np.testing.assert_allclose(got.position, want.position, atol=1e-5)
        np.testing.assert_allclose(quat_to_matrix(got.rotation), quat_to_matrix(want.rotation),
                                   atol=1e-5)


# --- parity with the JAX package ---------------------------------------------


def test_bin_files_byte_equal_to_jax(tmp_path):
    cams, images, xyz, rgb = _records(seed=4)
    for mod, d in ((colmap, tmp_path / "port"), (jcolmap, tmp_path / "jax")):
        d.mkdir()
        mod.write_cameras_bin(d / "cameras.bin", [mod.ColmapCamera(*c) for c in cams])
        mod.write_images_bin(d / "images.bin", [mod.ColmapImage(*im) for im in images])
        mod.write_points3d_bin(d / "points3D.bin", xyz, rgb)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


@pytest.mark.parametrize("aspect", [1.0, 4 / 3])
def test_export_model_byte_equal_to_jax(tmp_path, aspect):
    rng = np.random.default_rng(9)
    cams = [_random_camera(rng, aspect) for _ in range(3)]
    names = [f"frame_{i:04d}.png" for i in range(3)]
    xyz = rng.standard_normal((7, 3)).astype(np.float32)
    rgb = rng.uniform(0, 1, (7, 3)).astype(np.float32)
    sp = colmap.export_model(tmp_path / "port", cams, names, 48, 36, xyz, rgb)
    sj = jcolmap.export_model(tmp_path / "jax", [_jax_camera(c) for c in cams], names, 48, 36,
                              xyz, rgb)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (sp / name).read_bytes() == (sj / name).read_bytes()


@pytest.mark.parametrize("layout", ["bin", "txt"])
def test_load_model_and_dataset_equal_jax(tmp_path, layout):
    root = tmp_path / "ws"
    scene, _, cams, names = _rendered_workspace(root, n_views=2, size=16)
    xyz = scene.means.numpy().T[:20].astype(np.float32)
    rgb = np.full((20, 3), 0.25, np.float32)
    sparse = colmap.export_model(root, cams, names, 16, 16, xyz, rgb)
    if layout == "txt":
        m = colmap.load_model(root)
        for f in sparse.iterdir():
            f.unlink()
        _write_txt_model(sparse, list(m.cameras.values()), m.images, xyz, rgb)
    got, want = colmap.load_model(root), jcolmap.load_model(root)
    assert [i.name for i in got.images] == [i.name for i in want.images]
    for a, b in zip(got.images, want.images):
        np.testing.assert_array_equal(a.qvec, b.qvec)
        np.testing.assert_array_equal(a.tvec, b.tvec)
    np.testing.assert_array_equal(got.points_xyz, want.points_xyz)
    np.testing.assert_array_equal(got.points_rgb, want.points_rgb)
    gd, wd = colmap.load_dataset(root), jcolmap.load_dataset(root)
    _assert_cameras_equal(gd[0], wd[0])
    for g, w in zip(gd[1:], wd[1:]):
        np.testing.assert_array_equal(g, w)
