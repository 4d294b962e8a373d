"""A CPU smoke test of the port's bench (cudagaussianrenderer_torch.bench):
its JSON lines carry bench.py's headline keys plus ``saturated``,
``device`` and ``stages_ms``, and its pairs/frame is the port's own
``render_frame`` count on the same cameras.  No JAX frame here."""

import json

import pytest
import torch

from cudagaussianrenderer_torch import bench
from cudagaussianrenderer_torch.render import render_frame

# The headline keys of the JAX package's bench.py (bench.py:265-276).
BENCH_PY_KEYS = {"metric", "value", "unit", "vs_baseline", "ms_per_frame", "pairs_per_frame",
                 "pairs_per_sec_M", "capacity", "devices"}


def test_bench_cpu_lines_and_pair_count(capsys):
    result = bench.main(["2000", "2", "--size", "128", "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert len(lines) == 2
    head, last = lines
    assert BENCH_PY_KEYS | {"saturated", "device"} == set(head)
    assert set(last) == set(head) | {"stages_ms"} and last == result
    assert last["device"] == "cpu" and last["devices"] == 1 and last["saturated"] is False
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


def test_bench_refuses_what_it_cannot_measure():
    with pytest.raises(NotImplementedError):
        bench.main(["2000", "2", "--devices", "2", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench.main(["2000", "2", "--size", "128"])
