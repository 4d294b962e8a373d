"""A CPU smoke test of the port's bench (cudagaussianrenderer_torch.bench):
its JSON lines carry bench.py's headline keys plus ``method``, the eager
figures, ``graph_frames_equal``, ``device_busy_ms``, ``saturated``,
``device`` and ``stages_ms``, and its pairs/frame is the port's own
``render_frame`` count on the same cameras.  On the CPU the bench runs
eagerly; the graphed orbit needs the card (tests/test_torch_kernels_cuda.py).
Here the frame's device part, ``render_frame_tensors``, is held against
``render_frame`` through a static camera buffer refilled from a table, as
the graph replays it.  No JAX frame here."""

import json

import numpy as np
import pytest
import torch

from cudagaussianrenderer_torch import bench
from cudagaussianrenderer_torch.config import RenderConfig
from cudagaussianrenderer_torch.models.camera import orbit_cameras
from cudagaussianrenderer_torch.models.scene import random_scene
from cudagaussianrenderer_torch.render import (
    CAMERA_FLOATS, _band_rows_tensor, camera_array, camera_tensors, camera_views, render_frame,
    render_frame_tensors,
)

from torch_port_cases import one_torch_thread  # noqa: F401 (an autouse fixture)

# The headline keys of the JAX package's bench.py (bench.py:265-276).
BENCH_PY_KEYS = {"metric", "value", "unit", "vs_baseline", "ms_per_frame", "pairs_per_frame",
                 "pairs_per_sec_M", "capacity", "devices"}


def test_bench_cpu_lines_and_pair_count(capsys):
    result = bench.main(["2000", "2", "--size", "128", "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert len(lines) == 2
    head, last = lines
    assert BENCH_PY_KEYS | {"method", "eager_fps", "eager_ms_per_frame", "graph_frames_equal",
                            "device_busy_ms", "saturated", "device"} == set(head)
    assert set(last) == set(head) | {"stages_ms"} and last == result
    assert last["device"] == "cpu" and last["devices"] == 1 and last["saturated"] is False
    # On the CPU the headline is the eager loop itself.
    assert last["method"] == "eager"
    assert (last["eager_fps"], last["eager_ms_per_frame"]) == (last["value"], last["ms_per_frame"])
    assert last["graph_frames_equal"] is None and last["device_busy_ms"] is None
    assert last["metric"] == "fps_128x128_2k_splats" and last["value"] > 0
    assert set(last["stages_ms"]) == {"evaluateClipData", "buildTileList", "sortTileList",
                                      "evaluateTileRanges", "renderDepthBuffer"}

    # The same scene, cameras and capacity through render_frame.
    scene = bench.random_scene(2000, seed=0, min_scale=0.002, max_scale=0.053, extent=4.0,
                               device="cpu").pad_to_multiple(bench.GRAIN)
    config = bench.RenderConfig(screen_size=128)
    cams = bench.orbit_cameras(scene.bounds_min, scene.bounds_max, 2)
    pairs = [int(render_frame(scene, c.camera_data(), config, last["capacity"], device="cpu")[1]
                 ["num_pairs"]) for c in cams]
    assert last["pairs_per_frame"] == int(torch.tensor(pairs, dtype=torch.float64).mean())
    assert last["capacity"] % bench.GRAIN == 0


def test_bench_refuses_what_it_cannot_measure(capsys):
    """--devices 2 on the CPU runs two gloo ranks, tile-row sharded, with
    --devices 1's pairs/frame; without a card the default device raises,
    for one rank or two."""
    one = bench.main(["2000", "2", "--size", "128", "--device", "cpu", "--no-stages"])
    two = bench.main(["2000", "2", "--size", "128", "--device", "cpu", "--devices", "2"])
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert lines == [one, two]
    assert set(two) == set(one) | {"collective_ms"} and two["devices"] == 2 and one["devices"] == 1
    assert two["device_busy_ms"] is None and two["collective_ms"] is None
    assert two["pairs_per_frame"] == one["pairs_per_frame"] > 0
    assert two["method"] == "eager" and two["device"] == "cpu" and two["saturated"] is False
    assert two["capacity"] == max(bench.GRAIN, -(-one["capacity"] * 2 // 2 // bench.GRAIN)
                                  * bench.GRAIN)
    with pytest.raises(ValueError):
        bench.main(["2000", "2", "--devices", "0", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench.main(["2000", "2", "--size", "128", "--devices", "2"])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench.main(["2000", "2", "--size", "128"])


@pytest.mark.parametrize("cfg_kw", [dict(screen_size=64), dict(screen_size=64, sort_bands=4),
                                    dict(screen_size=64, background=(0.2, 0.4, 1.0))],
                         ids=["flat", "banded", "background"])
def test_frame_tensors_from_a_refilled_camera_equal_render_frame(cfg_kw):
    """The data flow of the graphed orbit, without the graph: one static
    camera buffer refilled in place from a [frames, CAMERA_FLOATS] table
    before each frame gives each camera's render_frame, byte for byte."""
    scene = random_scene(400, seed=7, device="cpu").pad_to_multiple(256)
    config = RenderConfig(**cfg_kw)
    cams = orbit_cameras(scene.bounds_min, scene.bounds_max, 3)
    table = torch.from_numpy(np.stack([camera_array(c.camera_data()) for c in cams]))
    assert table.shape == (3, CAMERA_FLOATS)
    static = torch.empty(CAMERA_FLOATS)
    views = camera_views(static)
    rows = _band_rows_tensor(None, config, "cpu") if config.sort_bands > 1 else None
    for i, c in enumerate(cams):
        static.copy_(table[i])
        got, aux = render_frame_tensors(scene, views, config, 8192, band_rows=rows)
        want, want_aux = render_frame(scene, c.camera_data(), config, 8192, device="cpu")
        assert torch.equal(got, want)
        assert int(aux["num_pairs"]) == int(want_aux["num_pairs"]) > 0
        assert int(aux["num_candidates"]) == int(want_aux["num_candidates"])
        for k, v in camera_tensors(c.camera_data(), "cpu").items():
            assert torch.equal(views[k], v)
    if config.sort_bands > 1:
        with pytest.raises(ValueError, match="band_rows"):
            render_frame_tensors(scene, views, config, 8192)
