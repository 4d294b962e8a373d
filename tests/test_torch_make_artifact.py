"""The port's 1M-splat artifact tool (cudagaussianrenderer_torch.tools.
make_artifact) small on the CPU: 2000 splats at 64x64 over 4 frames into a
temporary directory, through the native importer; and its .ply, which
holds the JAX tool's draws: random_scene's (seed 0, the suite's scales,
SH degree 3) as raw values."""

import json

import numpy as np

from cudagaussianrenderer_torch.models.scene import random_scene
from cudagaussianrenderer_torch.ply import load_gaussian_ply
from cudagaussianrenderer_torch.tools import make_artifact
from cudagaussianrenderer_torch.utils.png import read_png

from torch_port_cases import one_torch_thread  # noqa: F401

JAX_KEYS = ("config", "splats", "sh_degree", "ply_mb", "native_import_s", "ms_per_frame", "fps",
            "pairs_per_frame", "capacity")


def test_make_artifact_small_on_cpu(tmp_path):
    rec = make_artifact.main(["--n", "2000", "--size", "64", "--frames", "4", "--device", "cpu",
                              "--out", str(tmp_path / "out"), "--ply", str(tmp_path / "s.ply")])
    assert tuple(rec)[:len(JAX_KEYS)] == JAX_KEYS
    assert rec["importer"] == "native" and rec["config"] == "artifact_1m_sh3_native_ply_1024px"
    assert rec["splats"] == 2000 and rec["device"] == "cpu" and not rec["saturated"]
    assert rec["pairs_per_frame"] > 0 and rec["capacity"] % (1 << 16) == 0
    assert json.loads((tmp_path / "out" / "artifact_1m_sh3.json").read_text()) == rec
    for i in (0, 2):
        img = read_png(tmp_path / "out" / f"artifact_1m_sh3_frame{i}.png")
        assert img.shape == (64, 64, 4) and img[..., 3].max() == 255
    assert rec["ply_mb"] == round((tmp_path / "s.ply").stat().st_size / 1e6, 1)


def test_artifact_ply_holds_random_scene_values(tmp_path):
    path = tmp_path / "s.ply"
    make_artifact.write_scene_ply(path, 500)
    got = load_gaussian_ply(path, use_native=False, device="cpu")
    want = random_scene(500, seed=0, min_scale=0.002, max_scale=0.053, sh_degree=3, device="cpu")
    assert got.count == 500 and got.sh_degree == 3
    np.testing.assert_array_equal(got.means.numpy(), want.means.numpy())
    for f, tol in (("scales", 1e-6), ("opacities", 1e-5), ("colors", 1e-6), ("sh", 1e-6)):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f).numpy(), rtol=tol,
                                   atol=tol, err_msg=f)
