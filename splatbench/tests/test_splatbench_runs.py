"""Whole runs of the harness on the CPU at a tiny configuration: a sound
run is correct, the faults the cells can have are not, a configuration, a
traffic mix and a per-layer metric are taken up by adding files, and the
run loads no JAX."""

import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from splatbench import run
from splatbench.tests.tiny import REPO, tiny_root

SEED = 2**31 + 101


def cpu_run(root, cell="tiny.turntable", seconds=1.0, trace=False, seed=SEED):
    return run.run_cell(root, cell, seed, seconds, trace, device="cpu")


def test_sound_run_is_correct(tmp_path):
    result = cpu_run(tiny_root(tmp_path), cell="tiny.flythrough", trace=True)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == {"mean_abs", "bad_share", "tiles_off",
                                     "coverage_missing", "pairs_missing"}
    assert "loop.replay_share" in result["metrics"]


def _stale(monkeypatch):
    """A frame that returns the frame before it, as a replay whose outputs
    were not written would."""
    from cudagaussianrenderer_torch.render import Renderer

    render = Renderer.render
    last = {}

    def stale(self, camera, **kw):
        image = render(self, camera, **kw)
        out = last.get("image", image)
        last["image"] = image
        return out

    monkeypatch.setattr(Renderer, "render", stale)


def _half_scene(monkeypatch):
    """Half of the scene's splats left out of every frame."""
    from cudagaussianrenderer_torch import render as program_render

    frame = program_render.render_frame_tensors

    def half(scene, *args, **kw):
        keep = torch.arange(scene.opacities.shape[0], device=scene.opacities.device) % 2 == 0
        return frame(dataclasses.replace(scene, opacities=scene.opacities * keep), *args, **kw)

    monkeypatch.setattr(program_render, "render_frame_tensors", half)


def _altered_tiles(monkeypatch):
    """One row of tiles of every frame altered where the image is made, as
    a fault in the raster's tile indexing would."""
    from cudagaussianrenderer_torch import render as program_render

    to_image = program_render.tiles_to_image

    def altered(tiles, config):
        image = to_image(tiles, config).clone()
        ts = config.tile_size
        image[ts:2 * ts, :, :3] = 255 - image[ts:2 * ts, :, :3]
        return image

    monkeypatch.setattr(program_render, "tiles_to_image", altered)


@pytest.mark.parametrize("fault", [_stale, _half_scene, _altered_tiles])
@pytest.mark.parametrize("cell", ["tiny.turntable", "tiny.flythrough"])
def test_fault_is_not_correct(tmp_path, monkeypatch, fault, cell):
    fault(monkeypatch)
    result = cpu_run(tiny_root(tmp_path), cell=cell)
    assert not result["correct"], result["checks"]


def test_new_config_traffic_and_metric_are_files(tmp_path):
    """A cell on a new configuration and traffic mix with a new per-layer
    metric runs from added files and entries alone."""
    root = tiny_root(tmp_path)
    bench_dir = root / "splatbench"
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    cfg = json.loads((bench_dir / "configs" / "tiny.json").read_text())
    cfg["screen"] = {"width": 96, "height": 64, "tile": 16}
    (bench_dir / "configs" / "tiny-wide.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "hover.json").write_text(json.dumps({
        "azimuth_frames": 50, "phase": 0.25, "distance": {"base": 1.2, "amp": 0.05, "frames": 7},
        "elevation": {"base": 0.3}, "warmup": {"poses": 2, "passes": 1}}))
    (bench_dir / "metrics" / "loop.frames.py").write_text(
        "def read(r):\n    return float(len(r.frames))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-wide", "source": "https://arxiv.org/abs/2308.04079",
                             "file": "splatbench/configs/tiny-wide.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "wide.hover", "config": "tiny-wide", "traffic": "hover",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "loop.frames", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "frame loop",
                               "moves": "frame_ms", "workloads": ["wide.hover"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result = cpu_run(root, cell="wide.hover", trace=True)
    assert result["correct"]
    assert result["metrics"]["loop.frames"]["value"] > 0
    assert all(p.read_bytes() == b for p, b in before.items())


def test_sessions_open_the_scene_anew(monkeypatch):
    """A mix with sessions opens a new Renderer every ``session_frames``
    window frames and flies the path from its start in each; without, one
    Renderer goes on from the warm-up's last pose."""
    opened = []

    def open_renderer():
        opened.append(object())
        return opened[-1]

    monkeypatch.setattr(run, "frame", lambda renderer, path, k, j, stage: ((renderer, k, j), None))
    viewer = run.Viewer(open_renderer, None, {"session_frames": 3, "warmup": {"poses": 1}})
    shown = [viewer.window_frame(j)[0] for j in range(7)]
    assert [k for _, k, _ in shown] == [0, 1, 2, 0, 1, 2, 0]
    assert [opened.index(r) for r, _, _ in shown] == [1, 1, 1, 2, 2, 2, 3]
    opened.clear()
    viewer = run.Viewer(open_renderer, None, {"warmup": {"poses": 120}})
    shown = [viewer.window_frame(j)[0] for j in range(4)]
    assert [k for _, k, _ in shown] == [120, 121, 122, 123]
    assert len(opened) == 1


@pytest.mark.parametrize("key,value", [("precision", "float16"), ("falloff", "epanechnikov"),
                                       ("opacity_aware_extents", False),
                                       ("center_sampled_runs", False), ("falloff", None)])
def test_config_frame_value_the_run_does_not_honour_is_refused(tmp_path, key, value):
    """A configuration whose frame states a value that the program's
    RenderConfig or the reference would not be run with is refused, not
    run at the defaults."""
    root = tiny_root(tmp_path)
    path = root / "splatbench" / "configs" / "tiny.json"
    cfg = json.loads(path.read_text())
    if value is None:
        del cfg["frame"][key]
    else:
        cfg["frame"][key] = value
    path.write_text(json.dumps(cfg))
    with pytest.raises(SystemExit, match=key):
        run.load_cell(root, "tiny.turntable")


def test_command_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    out = subprocess.run([sys.executable, "-m", "splatbench.run", "--workload",
                          "tt1080.turntable", "--seed", str(2**31 + 5), "--seconds", "1",
                          "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""


def test_run_loads_no_jax(tmp_path):
    """A short run in a process of its own, on the CPU's plain path, leaves
    no module of JAX or of the JAX package loaded."""
    root = tiny_root(tmp_path)
    code = (
        "import sys, json\n"
        "from pathlib import Path\n"
        "from splatbench import run\n"
        f"r = run.run_cell(Path({str(root)!r}), 'tiny.flythrough', 7, 1.0, True, device='cpu')\n"
        "print(json.dumps({'correct': r['correct'], 'loaded': run.forbidden_loaded(),\n"
        "                  'tops': sorted({m.split('.')[0] for m in sys.modules})}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(root) + os.pathsep + str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert got["loaded"] == []
    assert not {"jax", "jaxlib", "flax", "cudagaussianrenderer_tpu"} & set(got["tops"])
    assert "cudagaussianrenderer_torch" in got["tops"]


def test_harness_reads_no_jax_era_file():
    """No source of the benchmark names the JAX package or its records."""
    era = re.compile(r"(import|from) +(jax|jaxlib|flax|cudagaussianrenderer_tpu)\b"
                     r"|BASELINE\.json|BENCH_r0|MULTICHIP_r0|bench_suite|(^|[^.\w])bench\.py")
    here = REPO / "splatbench"
    for path in here.rglob("*"):
        if path.suffix not in (".py", ".json") or "tests" in path.parts:
            continue
        assert not era.search(path.read_text()), path


@pytest.mark.cuda
def test_cell_on_the_card(tmp_path):
    """A short run of the tiny cells on the card: correct, every frame
    loop method met, the trace read."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    root = tiny_root(tmp_path, splats=200_000)
    result = run.run_cell(root, "tiny.flythrough", SEED, 3.0, True)
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0
    assert "stage.raster_ms" in result["metrics"]
    assert 0 < result["metrics"]["raster_roofline"]["value"] <= 100
