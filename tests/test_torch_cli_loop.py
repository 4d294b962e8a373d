"""The port's CLI frame loops: ``interactive``, ``bench`` and ``serve``, against
the JAX package's CLI with the same arguments (``--device cpu`` on the
port's side).

``interactive`` replays are deterministic (two runs give equal frames) and
their frames are held to the suite's rule against the JAX CLI's replay of
the same script (at most 2% of pixels off by more than 8 levels); ``bench``
prints the same report lines; ``serve`` answers its endpoints with a frame
held to the same rule against the JAX viewer's, on a free port that the test
picks."""

import json
import re
import threading
import urllib.request

import numpy as np
import pytest

from cudagaussianrenderer_torch import cli
from cudagaussianrenderer_torch import telemetry
from cudagaussianrenderer_torch.render import STAGE_NAMES
from cudagaussianrenderer_torch.utils.png import read_png
from cudagaussianrenderer_tpu import cli as jcli

from torch_port_cases import free_port, image_close, one_torch_thread  # noqa: F401 (one_torch_thread: an autouse fixture)


def _frames(out):
    return [read_png(f) for f in sorted(out.glob("frame_*.png"))]


def test_interactive_replay_is_deterministic(tmp_path):
    """tests/test_cli_and_profile.py's replay, through the port twice."""
    script = tmp_path / "script.jsonl"
    script.write_text("\n".join([
        '{"frames": 1, "buttons": "none", "pointer": [32, 32]}',
        '{"frames": 2, "buttons": "left", "pointer": [44, 32]}',
        '{"frames": 2, "buttons": "middle", "pointer": [44, 40]}',
        '{"frames": 1, "buttons": "none", "pointer": [44, 40], "move": [0, 0, -1]}',
    ]))
    outs = []
    for run in ("a", "b"):
        cli.main(["interactive", "--procedural", "200", "--size", "64", "--script", str(script),
                  "-o", str(tmp_path / run), "--device", "cpu"])
        outs.append(_frames(tmp_path / run))
        assert len(outs[-1]) == 6
    for fa, fb in zip(*outs):
        np.testing.assert_array_equal(fa, fb)
    assert (outs[0][0] != outs[0][-1]).any()  # the camera moved


def test_interactive_matches_jax(tmp_path):
    script = tmp_path / "script.jsonl"
    script.write_text("\n".join([
        '{"frames": 1, "buttons": "none", "pointer": [16, 16]}',
        '{"frames": 1, "buttons": "left", "pointer": [26, 16]}',
        '{"frames": 1, "buttons": "middle", "pointer": [26, 22], "move": [0, 0, -1]}',
    ]))
    args = ["interactive", "--procedural", "200", "--size", "32", "--script", str(script), "-o"]
    jcli.main(args + [str(tmp_path / "jax")])
    cli.main(args + [str(tmp_path / "port"), "--device", "cpu"])
    got, want = _frames(tmp_path / "port"), _frames(tmp_path / "jax")
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        image_close(g, w, f"interactive frame {i}")


def test_bench_prints_the_jax_report(capsys):
    args = ["bench", "--procedural", "60", "--size", "32", "--frames", "1"]
    jcli.main(args)
    jerr = capsys.readouterr().err
    cli.main(args + ["--profile", "--device", "cpu"])
    cap = capsys.readouterr()
    line = r"^1 frames in [0-9.]+ ms -> [0-9.]+ FPS$"
    assert re.search(line, jerr, re.M) and re.search(line, cap.err, re.M), (jerr, cap.err)
    stages = [ln.split(" average")[0] for ln in cap.out.splitlines()]
    assert stages == [n for n in STAGE_NAMES if n != "evaluateSphericalHarmonics"] + ["Total"]
    with pytest.raises(SystemExit, match="--frames must be >= 1"):
        cli.main(["bench", "--procedural", "60", "--frames", "0", "--device", "cpu"])


def _serve_frame(main, extra):
    """Start ``serve`` of ``main`` on a free port in a thread; return its
    first frame and its stats, then stop it."""
    port = free_port()
    argv = ["serve", "--procedural", "200", "--size", "32", "--port", str(port),
            "--fps-cap", "1000", *extra]
    t = threading.Thread(target=main, args=(argv,), daemon=True)
    t.start()
    base = f"http://127.0.0.1:{port}"
    for _ in range(600):  # the server thread binds the port before the first frame
        try:
            with urllib.request.urlopen(base + "/", timeout=5) as r:
                assert b"/stream" in r.read()
            break
        except OSError:
            t.join(0.1)
    try:
        with urllib.request.urlopen(base + "/frame.png", timeout=120) as r:
            frame = read_png(r.read())
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        urllib.request.urlopen(urllib.request.Request(base + "/quit", data=b"{}"), timeout=30)
    t.join(120)
    assert not t.is_alive()
    return frame, stats


def test_serve_matches_jax():
    want, jstats = _serve_frame(jcli.main, [])
    got, stats = _serve_frame(cli.main, ["--device", "cpu"])
    assert got.shape == want.shape == (32, 32, 4)
    image_close(got, want, "serve first frame")
    # The JAX viewer's stats, and the port's frame record's method and stages.
    assert stats["frame"] >= 0 and stats["capacity"] > 0
    assert set(stats) == set(jstats) | {"method", "stage_ms"}
    assert stats["method"] == "eager" and list(stats["stage_ms"]) == list(telemetry.STAGES)
