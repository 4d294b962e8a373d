"""The port's live HTTP viewer (cudagaussianrenderer_torch.viewer.serve) on the
CPU: the counterparts of tests/test_viewer.py's two tests.

The server listens on a free port that the test picks (files run in
parallel, so no fixed port); the render loop runs on the thread that calls
``serve``, as it does on the card."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from cudagaussianrenderer_torch import telemetry
from cudagaussianrenderer_torch.config import RenderConfig
from cudagaussianrenderer_torch.models.scene import random_scene
from cudagaussianrenderer_torch.render import Renderer
from cudagaussianrenderer_torch.utils.png import read_png
from cudagaussianrenderer_torch.viewer import ViewerState, serve

from torch_port_cases import free_port, one_torch_thread  # noqa: F401 (one_torch_thread: an autouse fixture)


def _get(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def _post(url, payload, timeout=10):
    req = urllib.request.Request(url, data=json.dumps(payload).encode())
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def test_viewer_serves_and_responds_to_input():
    scene = random_scene(200, seed=3, device="cpu")
    config = RenderConfig(screen_size=128)
    renderer = Renderer(scene, config, device="cpu")
    port = free_port()
    ready = threading.Event()
    holder = {}

    def run():
        holder["state"] = serve(renderer, scene, config, port=port, fps_cap=1000.0,
                                max_frames=0, ready=ready)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert ready.wait(30)
    base = f"http://127.0.0.1:{port}"

    def frame_no():
        return json.loads(_get(base + "/stats"))["frame"]

    def wait_frames(n, timeout=60.0):
        target = frame_no() + n
        deadline = time.monotonic() + timeout
        while frame_no() < target:
            assert time.monotonic() < deadline, "render loop stalled"
            time.sleep(0.02)

    try:
        page = _get(base + "/").decode()
        assert "/stream" in page and "mousedown" in page
        img0 = read_png(_get(base + "/frame.png"))
        assert img0.shape == (128, 128, 4) and img0[..., 3].max() == 255
        stats = json.loads(_get(base + "/stats"))
        assert stats["capacity"] > 0 and stats["pairs"] > 0
        # The last frame's record: how it ran and its stages' ms.
        assert stats["method"] == "eager"
        assert list(stats["stage_ms"]) == list(telemetry.STAGES)
        assert all(v >= 0.0 for v in stats["stage_ms"].values())

        # Drag-rotate: two pointer positions on different frames while the
        # left button is held (the controller uses frame deltas).
        _post(base + "/input", {"pointer": [5, 64], "buttons": "left"})
        wait_frames(2)
        _post(base + "/input", {"pointer": [120, 64], "buttons": "left"})
        wait_frames(2)
        _post(base + "/input", {"pointer": [120, 64], "buttons": "none"})
        wait_frames(1)
        img1 = read_png(_get(base + "/frame.png"))
        d = np.abs(img0.astype(int) - img1.astype(int))
        assert (d > 4).any(axis=-1).mean() > 0.01  # the view moved

        # The live stream hands out PNG parts.
        with urllib.request.urlopen(base + "/stream", timeout=30) as r:
            assert r.headers["Content-Type"].startswith("multipart/x-mixed-replace")
            assert r.readline() == b"--frame\r\n"
            assert r.readline() == b"Content-Type: image/png\r\n"

        # Bad input returns 400 without killing the loop.
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(base + "/input", data=b"not json"),
                                   timeout=10)
        assert e.value.code == 400
        wait_frames(1)  # loop survived
    finally:
        _post(base + "/quit", {})
    t.join(60)
    assert not t.is_alive()
    assert holder["state"].frame_id > 0


def test_set_input_validates_payload():
    state = ViewerState()
    state.set_input({"pointer": [1, 2], "buttons": "left", "move": [0, 0, 1]})
    assert state.get_input().buttons == "left"
    for bad in ({"buttons": "lefty"}, {"pointer": [1]}, {"pointer": [1, 2, 3]}, {"move": [1]},
                {"pointer": ["x", "y"]}, [1, 2]):
        with pytest.raises((ValueError, TypeError)):
            state.set_input(bad)
    assert state.get_input().buttons == "left"


def test_serve_stops_after_max_frames():
    scene = random_scene(100, seed=1, device="cpu")
    config = RenderConfig(screen_size=64)
    state = serve(Renderer(scene, config, device="cpu"), scene, config, port=free_port(),
                  fps_cap=1000.0, max_frames=3)
    assert state.frame_id == 3 and not state.running
    assert read_png(state.frame_png).shape == (64, 64, 4)
