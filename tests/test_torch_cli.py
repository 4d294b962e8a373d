"""The port's CLI (cudagaussianrenderer_torch.cli) against the JAX package's
CLI with the same arguments, ``--device cpu`` on the port's side: render
(``--depth`` too), compare, convert, merge, and what fit refuses.  tests/test_torch_cli_orbit.py covers orbit and eval,
tests/test_torch_cli_loop.py interactive, bench and serve.

Outputs that do not depend on pixels are byte-equal (converted and merged
scene files); frames are held to the suite's rule (tests/test_pipeline.py:
at most 2% of pixels off by more than 8 levels); compare prints the same
JSON, its SSIM within 1e-5."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cudagaussianrenderer_torch import cli
from cudagaussianrenderer_torch.config import RenderConfig
from cudagaussianrenderer_torch.golden import golden_render, scene_to_numpy
from cudagaussianrenderer_torch.models.camera import Camera
from cudagaussianrenderer_torch.models.scene import random_scene, random_scene_arrays
from cudagaussianrenderer_torch.ply import write_gaussian_ply
from cudagaussianrenderer_torch.utils.png import read_png, write_png
from cudagaussianrenderer_tpu import cli as jcli

from torch_port_cases import image_close, one_torch_thread  # noqa: F401 (one_torch_thread: an autouse fixture)

ROOT = Path(__file__).resolve().parent.parent


def port(*args):
    cli.main([*map(str, args), "--device", "cpu"])


def test_modules_import_without_jax():
    """cli, viewer, dataset, colmap, diff and the bench import in a process
    where importing jax or the JAX package raises."""
    code = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "cudagaussianrenderer_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import cudagaussianrenderer_torch
for m in ("cli", "viewer", "dataset", "colmap", "diff", "bench"):
    __import__("cudagaussianrenderer_torch." + m)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cudagaussianrenderer_tpu")]
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the default device is present here")
    for argv in (["render", "--procedural", "10", "--size", "32"],
                 ["compare", "a.png", "b.png"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv)


def test_render_matches_jax_and_golden(tmp_path):
    """render: the port's frame against the JAX CLI's and the golden oracle;
    the banded, multipass and background variants of the port against the
    same frames."""
    args = ["render", "--procedural", "300", "--size", "64", "-o"]
    jcli.main(args + [str(tmp_path / "jax.png")])
    port(*args, tmp_path / "port.png")
    want = read_png(tmp_path / "jax.png")
    got = read_png(tmp_path / "port.png")
    assert got.shape == want.shape == (64, 64, 4) and got[..., 3].max() == 255
    image_close(got, want, "render vs JAX")
    scene = random_scene(300, seed=0, device="cpu")
    config = RenderConfig(screen_size=64)
    cam = Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    image_close(got, golden_render(scene_to_numpy(scene), cam.camera_data(), config),
                "render vs golden")
    for extra in (["--bands", "4"], ["--passes", "2"]):
        out = tmp_path / f"port{extra[0]}.png"
        port(*args, out, *extra)
        image_close(read_png(out), want, f"render {' '.join(extra)} vs JAX")
    port(*args, tmp_path / "white.png", "--background", "white")
    white = golden_render(scene_to_numpy(scene), cam.camera_data(),
                          RenderConfig(screen_size=64, background=(1.0, 1.0, 1.0)))
    image_close(read_png(tmp_path / "white.png"), white, "render --background white vs golden")


@pytest.mark.parametrize("bands", ["0", "4"])
def test_render_again_after_a_truncated_first_frame(tmp_path, capsys, bands):
    """With --capacity-factor 1 the fresh Renderer's first frame overflows
    its pair list (and, banded, its compacted-splat axis): the CLI renders
    again with the grown lists, so the view passes the rule against the
    golden oracle."""
    port("render", "--procedural", "1000", "--size", "128", "--capacity-factor", "1",
         "--bands", bands, "-o", tmp_path / "t.png")
    assert "frame truncated" in capsys.readouterr().err
    scene = random_scene(1000, seed=0, device="cpu")
    cam = Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    want = golden_render(scene_to_numpy(scene), cam.camera_data(), RenderConfig(screen_size=128))
    image_close(read_png(tmp_path / "t.png"), want, f"render --bands {bands} after regrowth")


def test_fit_and_depth_refuse(tmp_path):
    """What fit still refuses (tests/test_cli_and_profile.py's
    test_fit_resume_guards, and --holdout without a dataset), with the JAX
    CLI's message for the same arguments; before any work, so neither
    writes a file.  render --depth renders: test_render_depth_matches_jax."""
    from cudagaussianrenderer_tpu import diff as jdiff

    ck = tmp_path / "ck.npz"
    fit = ["fit", "--procedural", "20", "--size", "32", "--steps", "5", "--splats", "8",
           "--k-max", "64", "-o", str(tmp_path / "x.ply")]
    p = jdiff.random_init(8, (-1, -1, -1), (1, 1, 1), seed=0)
    cases = [
        (lambda: jdiff.save_checkpoint(ck, p, step=5), [*fit, "--checkpoint", str(ck), "--resume"],
         "already at step 5"),
        (lambda: jdiff.save_checkpoint(ck, p, step=2, camera_deltas=jdiff.zero_camera_deltas(2)),
         [*fit, "--checkpoint", str(ck), "--resume"], "refine-poses"),
        (lambda: jdiff.save_checkpoint(ck, p, step=2, exposure=jdiff.identity_exposure(2)),
         [*fit, "--checkpoint", str(ck), "--resume", "--refine-poses"], "refine-exposure"),
        (lambda: None, [*fit, "--resume"], "needs --checkpoint"),
        (lambda: None, [*fit, "--holdout", "2"], "needs --dataset"),
    ]
    for write, argv, match in cases:
        write()
        with pytest.raises(SystemExit, match=match) as want:
            jcli.main(argv)
        with pytest.raises(SystemExit, match=match) as got:
            port(*argv)
        assert str(got.value) == str(want.value)
    assert sorted(f.name for f in tmp_path.iterdir()) == ["ck.npz"]


def test_render_depth_matches_jax(tmp_path):
    """render --depth (tests/test_cli_and_profile.py's test_render_depth_flag)
    writes the colour frame and a grey, normalized expected-depth PNG; both
    against the JAX CLI's with the same arguments."""
    args = ["render", "--procedural", "60", "--size", "32"]
    jcli.main([*args, "-o", str(tmp_path / "jc.png"), "--depth", str(tmp_path / "jd.png")])
    port(*args, "-o", tmp_path / "c.png", "--depth", tmp_path / "d.png")
    got, want = read_png(tmp_path / "d.png"), read_png(tmp_path / "jd.png")
    assert got.shape == want.shape == (32, 32, 3)
    assert (got[..., 0] == got[..., 1]).all() and (got[..., 0] == got[..., 2]).all()
    assert got.min() == 0 and got.max() == 255
    image_close(got, want, "render --depth vs JAX")
    image_close(read_png(tmp_path / "c.png"), read_png(tmp_path / "jc.png"), "render vs JAX")


def _pngs(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    b = a.copy()
    b[0, 0, 0] ^= 4
    c = np.clip(a.astype(int) + rng.integers(-20, 21, a.shape), 0, 255).astype(np.uint8)
    d = rng.integers(0, 256, (32, 32, 4), dtype=np.uint8)
    paths = {}
    for name, img in dict(a=a, b=b, c=c, d=d, e=np.roll(d, 3, axis=0)).items():
        paths[name] = tmp_path / f"{name}.png"
        write_png(paths[name], img)
    return paths


@pytest.mark.parametrize("pair", ["aa", "ab", "ac", "de"])
def test_compare_matches_jax(tmp_path, capsys, pair):
    p = _pngs(tmp_path)
    x, y = p[pair[0]], p[pair[1]]
    jcli.main(["compare", str(x), str(y)])
    want = json.loads(capsys.readouterr().out)
    port("compare", x, y)
    got = json.loads(capsys.readouterr().out)
    assert abs(got.pop("ssim") - want.pop("ssim")) <= 1e-5
    assert got == want
    if pair == "aa":
        assert want["max_delta"] == 0 and want["psnr_db"] == "inf"
    if pair == "ab":
        assert want["max_delta"] == 4 and want["psnr_db"] > 40
        with pytest.raises(SystemExit, match="exceeds"):
            port("compare", x, y, "--max-delta", "2")
        port("compare", x, y, "--max-delta", "4")


@pytest.fixture
def scene_files(tmp_path):
    """Two raw .ply scenes (SH degrees 1 and 0) and a .splat."""
    paths = {}
    for name, n, seed, sh in (("a", 300, 1, 1), ("b", 200, 2, 0)):
        d = random_scene_arrays(n, seed=seed, sh_degree=sh)
        with np.errstate(divide="ignore"):
            f_rest = None if d["sh"] is None else np.transpose(d["sh"][:, 1:, :], (0, 2, 1))
            f_dc = ((d["colors"] - 0.5) / 0.28209479177387814 if d["sh"] is None
                    else d["sh"][:, 0, :])
            write_gaussian_ply(tmp_path / f"{name}.ply", d["means"], np.log(d["scales"]),
                               d["quats_xyzw"][:, [3, 0, 1, 2]],
                               np.log(d["opacities"]) - np.log1p(-d["opacities"]), f_dc, f_rest)
        paths[name] = tmp_path / f"{name}.ply"
    jcli.main(["convert", str(paths["b"]), str(tmp_path / "b.splat")])
    paths["s"] = tmp_path / "b.splat"
    return paths


CONVERT_CASES = [
    ("ply-to-splat", "a", ".splat", []),
    ("ply-to-ply", "a", ".ply", []),
    ("splat-to-ply", "s", ".ply", []),
    ("ply-edits", "a", ".ply", ["--crop=-3,-3,-3,3,3,3", "--min-opacity", "0.2",
                                "--max-splats", "50", "--translate", "0.5,0,-1", "--scale", "2"]),
    ("splat-edits", "s", ".splat", ["--max-splats", "80", "--scale", "0.5"]),
]


@pytest.mark.parametrize("name,src,ext,flags", CONVERT_CASES, ids=[c[0] for c in CONVERT_CASES])
def test_convert_byte_equal_to_jax(tmp_path, scene_files, name, src, ext, flags):
    jout, pout = tmp_path / f"jax{ext}", tmp_path / f"port{ext}"
    jcli.main(["convert", str(scene_files[src]), str(jout), *flags])
    port("convert", scene_files[src], pout, *flags)
    assert pout.read_bytes() == jout.read_bytes()


@pytest.mark.parametrize("ext,flags", [(".ply", []), (".splat", []),
                                       (".ply", ["--min-opacity", "0.5", "--translate", "1,2,3"])],
                         ids=["ply", "splat", "ply-edits"])
def test_merge_byte_equal_to_jax(tmp_path, scene_files, ext, flags):
    inputs = [str(scene_files[k]) for k in ("a", "b", "s")]
    jout, pout = tmp_path / f"jax{ext}", tmp_path / f"port{ext}"
    jcli.main(["merge", *inputs, "-o", str(jout), *flags])
    port("merge", *inputs, "-o", pout, *flags)
    assert pout.read_bytes() == jout.read_bytes()
    with pytest.raises(SystemExit, match="scene edit failed"):
        port("merge", *inputs, "-o", tmp_path / "x.ply", "--max-splats", "-1")
