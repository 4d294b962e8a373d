"""The port's CLI ``orbit`` and ``eval`` against the JAX package's CLI with the
same arguments (``--device cpu`` on the port's side).

``transforms.json`` and the COLMAP model are byte-equal; the frames are held
to the suite's rule (at most 2% of pixels off by more than 8 levels); the
posed dataset both packages load from either workspace is the same; ``eval``
of the ground-truth scene against its own orbit scores near-perfect in both
(PSNR > 40 dB, SSIM > 0.99, as tests/test_cli_and_profile.py asks of the
JAX CLI)."""

import re

import numpy as np
import pytest

from cudagaussianrenderer_torch import cli
from cudagaussianrenderer_torch.dataset import load_posed
from cudagaussianrenderer_torch.models.scene import random_scene
from cudagaussianrenderer_torch.utils.png import read_png
from cudagaussianrenderer_tpu import cli as jcli
from cudagaussianrenderer_tpu.dataset import load_posed as jload_posed

from torch_port_cases import image_close, one_torch_thread  # noqa: F401 (one_torch_thread: an autouse fixture)

ORBIT = ["orbit", "--procedural", "60", "--seed", "3", "--size", "32", "-n", "2",
         "--transforms", "--colmap", "-o"]


@pytest.fixture(scope="module")
def workspaces(tmp_path_factory):
    root = tmp_path_factory.mktemp("orbit")
    jcli.main(ORBIT + [str(root / "jax")])
    cli.main(ORBIT + [str(root / "port"), "--device", "cpu"])
    return root / "jax", root / "port"


def test_orbit_files_byte_equal_and_frames_close(workspaces):
    jax_ws, port_ws = workspaces
    for rel in ("transforms.json", "sparse/0/cameras.bin", "sparse/0/images.bin",
                "sparse/0/points3D.bin"):
        assert (port_ws / rel).read_bytes() == (jax_ws / rel).read_bytes(), rel
    names = sorted(p.name for p in (jax_ws / "images").iterdir())
    assert names == sorted(p.name for p in (port_ws / "images").iterdir())
    assert names == ["frame_0000.png", "frame_0001.png"]
    for name in names:
        got, want = read_png(port_ws / "images" / name), read_png(jax_ws / "images" / name)
        assert got.shape == want.shape == (32, 32, 4) and got[..., 3].max() == 255
        image_close(got, want, name)


@pytest.mark.parametrize("layout", ["colmap", "transforms"])
def test_load_posed_of_orbit_equals_jax(workspaces, tmp_path, layout):
    """Both packages load the port's workspace to the same dataset: cameras
    whose camera_data() is equal, bit-equal images and points."""
    _, port_ws = workspaces
    src = port_ws
    if layout == "transforms":
        # The NeRF-synthetic layout alone: the json and the frames it names.
        src = tmp_path / "t"
        (src / "images").mkdir(parents=True)
        (src / "transforms.json").write_bytes((port_ws / "transforms.json").read_bytes())
        for p in (port_ws / "images").iterdir():
            (src / "images" / p.name).write_bytes(p.read_bytes())
    got, want = load_posed(src), jload_posed(src)
    assert len(got.cameras) == len(want.cameras) == 2
    for g, w in zip(got.cameras, want.cameras):
        gd, wd = g.camera_data(), w.camera_data()
        for k in gd:
            np.testing.assert_array_equal(gd[k], wd[k])
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.points_xyz, want.points_xyz)
    assert got.names == want.names
    if layout == "colmap":
        scene = random_scene(60, seed=3, device="cpu")
        np.testing.assert_array_equal(got.points_xyz, scene.means.numpy().T)


def _scores(err):
    m = re.search(r"PSNR ([0-9.]+|inf) dB, SSIM ([0-9.]+)", err)
    assert m, err
    return float(m.group(1)), float(m.group(2))


def test_eval_matches_jax(workspaces, tmp_path, capsys):
    """eval of the ground-truth scene (written as a .ply by the CLI's scene
    writer) against its orbit, in both packages."""
    _, port_ws = workspaces
    gt = tmp_path / "gt.ply"
    cli._write_scene(random_scene(60, seed=3, device="cpu"), gt)
    capsys.readouterr()
    jcli.main(["eval", str(gt), "--dataset", str(port_ws)])
    jpsnr, jssim = _scores(capsys.readouterr().err)
    cli.main(["eval", str(gt), "--dataset", str(port_ws), "--device", "cpu"])
    psnr, ssim = _scores(capsys.readouterr().err)
    assert psnr > 40 and jpsnr > 40
    assert ssim > 0.99 and jssim > 0.99
    assert abs(ssim - jssim) <= 0.01
