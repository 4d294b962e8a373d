"""A copy of the benchmark with a tiny configuration beside the real ones,
for runs on the CPU: the harness finds it by name as it finds any other."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
# Splats and screen of the tiny configuration: a few seconds a CPU run.
SPLATS, WIDTH, HEIGHT = 6000, 128, 96


def tiny_root(tmp: Path, *, splats: int = SPLATS, config: str = "tt-3dgs-1080p") -> Path:
    """``tmp`` holding BENCHMARK.json and splatbench/ with configuration
    ``tiny`` (``config``'s file with its scene and screen cut) and the cells
    ``tiny.turntable`` and ``tiny.flythrough``; the turntable turns in 6
    frames, and the fly-through's sessions are 3 frames of a path that
    turns in 12."""
    root = tmp / "bench"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root)
    shutil.copytree(REPO / "splatbench", root / "splatbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((root / "splatbench" / "configs" / f"{config}.json").read_text())
    cfg["scene"]["splats"] = splats
    cfg["screen"] = {"width": WIDTH, "height": HEIGHT, "tile": 16}
    (root / "splatbench" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    turn = json.loads((root / "splatbench" / "traffic" / "turntable.json").read_text())
    turn["azimuth_frames"] = turn["warmup"]["poses"] = 6
    (root / "splatbench" / "traffic" / "turntable6.json").write_text(json.dumps(turn))
    fly = json.loads((root / "splatbench" / "traffic" / "flythrough.json").read_text())
    fly.update(azimuth_frames=12, session_frames=3)
    fly["distance"]["frames"] = 6
    (root / "splatbench" / "traffic" / "flythrough3.json").write_text(json.dumps(fly))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "https://arxiv.org/abs/2308.04079",
                             "file": "splatbench/configs/tiny.json", "reduced": ["splats"],
                             "why": "CPU tests"})
    for cell, traffic in (("tiny.turntable", "turntable6"), ("tiny.flythrough", "flythrough3")):
        bench["workloads"].append({"name": cell, "config": "tiny", "traffic": traffic,
                                   "chips": 1, "why": "CPU tests"})
        for m in bench["per_layer"]:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    return root
