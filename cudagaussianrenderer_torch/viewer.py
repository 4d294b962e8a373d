"""Live interactive viewer — the presentation layer.

The CUDA reference presents frames through a GLFW window and polls its
mouse/keyboard each frame (its src/Demo.cpp:196-237, 352-528).  The port
renders headless on the card's host, like the JAX package, so its
presentation layer is the same tiny dependency-free HTTP server:

  * GET  /            — viewer page (canvas + pointer/keyboard capture)
  * GET  /stream      — multipart/x-mixed-replace PNG stream (live view)
  * GET  /frame.png   — latest rendered frame (single shot)
  * POST /input       — InputState JSON {pointer, buttons, move}
  * GET  /stats       — renderer stats JSON (fps, pairs, capacity, and the
                         last frame's method and stage ms from its record)

The render loop is the reference's frame loop: poll input →
CameraController.update (drag/orbit/pan/WASD, CameraControls.cpp:
148-253 semantics) → render → present, with the same fixed-dt 60 FPS
cap (Demo.cpp:521-525).  The loop runs on the thread that calls
``serve`` and is the only one that touches the device: the HTTP handler
threads exchange input and finished PNG bytes with it through
``ViewerState`` and never touch a tensor.  Everything is standard library;
frames are PNG-encoded with utils.png.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .models.camera import CameraController, InputState
from .utils.png import encode_png

_PAGE = """<!doctype html>
<html><head><title>cudagaussianrenderer-torch</title><style>
 body { margin:0; background:#111; color:#ccc; font:13px monospace; }
 #wrap { display:flex; flex-direction:column; align-items:center; }
 img { image-rendering:auto; margin-top:8px; cursor:crosshair; }
 #bar { padding:6px; }
</style></head><body><div id="wrap">
<div id="bar">drag: rotate &middot; middle-drag: orbit &middot;
right-drag: pan &middot; WASD/QE: fly &middot; <span id="stats"></span></div>
<img id="view" src="/stream" draggable="false">
</div><script>
const img = document.getElementById('view');
let buttons = 'none', pointer = [0, 0];
const keys = new Set();
const names = {0: 'left', 1: 'middle', 2: 'right'};
img.addEventListener('contextmenu', e => e.preventDefault());
img.addEventListener('mousedown', e => { buttons = names[e.button] || 'none'; send(); });
window.addEventListener('mouseup', () => { buttons = 'none'; send(); });
img.addEventListener('mousemove', e => {
  const r = img.getBoundingClientRect();
  pointer = [e.clientX - r.left, e.clientY - r.top]; send();
});
window.addEventListener('keydown', e => { keys.add(e.key.toLowerCase()); send(); });
window.addEventListener('keyup', e => { keys.delete(e.key.toLowerCase()); send(); });
function move() {
  let m = [0, 0, 0];
  if (keys.has('w')) m[2] -= 1; if (keys.has('s')) m[2] += 1;
  if (keys.has('a')) m[0] -= 1; if (keys.has('d')) m[0] += 1;
  if (keys.has('q')) m[1] -= 1; if (keys.has('e')) m[1] += 1;
  return m;
}
let inflight = false;
function send() {
  if (inflight) return; inflight = true;
  fetch('/input', {method: 'POST', body: JSON.stringify(
    {pointer: pointer, buttons: buttons, move: move()})})
    .finally(() => { inflight = false; });
}
setInterval(send, 50);
setInterval(() => fetch('/stats').then(r => r.json()).then(s => {
  document.getElementById('stats').textContent =
    s.fps.toFixed(1) + ' fps, ' + s.pairs + ' pairs';
}), 1000);
</script></body></html>"""


class ViewerState:
    """Input + latest-frame exchange between the HTTP threads and the
    render loop (the GLFW event queue analog)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.input = InputState()
        self.frame_png = b""
        self.frame_id = 0
        self.frame_event = threading.Condition(self.lock)
        self.stats = {"fps": 0.0, "pairs": 0, "capacity": 0}
        self.running = True

    def set_input(self, data: dict) -> None:
        # Validate HERE (the HTTP handler thread, where a bad payload
        # becomes a 400) — a malformed state reaching the render loop
        # would crash the loop thread and kill the whole viewer.
        if not isinstance(data, dict):
            raise TypeError("input payload must be a JSON object")
        pointer = tuple(float(x) for x in data.get("pointer", (0.0, 0.0)))
        move = tuple(float(x) for x in data.get("move", (0.0, 0.0, 0.0)))
        buttons = str(data.get("buttons", "none"))
        if len(pointer) != 2:
            raise ValueError("pointer must be [x, y]")
        if len(move) != 3:
            raise ValueError("move must be [x, y, z]")
        if buttons not in ("none", "left", "middle", "right"):
            raise ValueError(f"unknown buttons value {buttons!r}")
        state = InputState(pointer=pointer, buttons=buttons, move=move)
        with self.lock:
            self.input = state

    def get_input(self) -> InputState:
        with self.lock:
            return self.input

    def publish(self, png: bytes, stats: dict) -> None:
        with self.frame_event:
            self.frame_png = png
            self.frame_id += 1
            self.stats = stats
            self.frame_event.notify_all()

    def next_frame(self, last_id: int, timeout: float = 120.0):
        """Block until a frame newer than ``last_id`` exists (the first
        frame can take the kernels' build; default timeout covers it)."""
        deadline = time.monotonic() + timeout
        with self.frame_event:
            while (self.frame_id == last_id or not self.frame_png) and self.running:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self.frame_event.wait(remaining):
                    break
            return self.frame_png, self.frame_id


def _make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/" or self.path.startswith("/index"):
                self._send(200, "text/html", _PAGE.encode())
            elif self.path.startswith("/frame.png"):
                png, _ = state.next_frame(-1)
                self._send(200, "image/png", png)
            elif self.path.startswith("/stats"):
                with state.lock:
                    body = json.dumps(state.stats).encode()
                self._send(200, "application/json", body)
            elif self.path.startswith("/stream"):
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=frame",
                )
                self.end_headers()
                last = -1
                try:
                    while state.running:
                        png, last = state.next_frame(last)
                        if not png:
                            continue
                        self.wfile.write(b"--frame\r\n")
                        self.wfile.write(b"Content-Type: image/png\r\n")
                        self.wfile.write(
                            f"Content-Length: {len(png)}\r\n\r\n".encode()
                        )
                        self.wfile.write(png)
                        self.wfile.write(b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass
            else:
                self._send(404, "text/plain", b"not found")

        def do_POST(self):
            if self.path.startswith("/input"):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    state.set_input(json.loads(self.rfile.read(n) or b"{}"))
                    self._send(200, "application/json", b"{}")
                except (ValueError, TypeError):
                    self._send(400, "text/plain", b"bad input")
            elif self.path.startswith("/quit"):
                # The reference quits on window close (Demo.cpp:352);
                # headless analog: stop the frame loop remotely.
                with state.frame_event:
                    state.running = False
                    state.frame_event.notify_all()
                self._send(200, "application/json", b"{}")
            else:
                self._send(404, "text/plain", b"not found")

    return Handler


def serve(
    renderer,
    scene,
    config,
    *,
    host: str = "127.0.0.1",
    port: int = 8000,
    fps_cap: float = 60.0,
    max_frames: int = 0,
    ready: threading.Event = None,
    stream_level: int = 0,
):
    """Run the interactive frame loop, presenting over HTTP.

    ``max_frames`` > 0 stops after that many frames (tests); 0 runs until
    interrupted.  Returns the ViewerState (tests poke it directly).

    ``stream_level`` is the zlib effort for the streamed PNGs.  The
    default 0 (stored blocks) is measured 4.6x faster to encode than
    level 1 at ~7x the bytes — the right trade for the loopback/LAN
    host this serves from; pass 1-9 when the link to the browser is
    the bottleneck instead of the encode.
    """
    state = ViewerState()
    controller = CameraController((config.screen_w, config.screen_h))
    controller.set_bounds(scene.bounds_min, scene.bounds_max)

    server = ThreadingHTTPServer((host, port), _make_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    if ready is not None:
        ready.set()

    dt = 1.0 / fps_cap
    rendered = 0
    ema_fps = 0.0
    try:
        while state.running and (max_frames == 0 or rendered < max_frames):
            t0 = time.perf_counter()
            cam = controller.update(state.get_input(), dt)
            image = renderer.render(cam)
            # Live stream favors latency over bytes (see stream_level).
            png = encode_png(image, level=stream_level)
            elapsed = time.perf_counter() - t0
            ema_fps = 0.9 * ema_fps + 0.1 * (1.0 / max(elapsed, 1e-6))
            stats = {
                "fps": round(ema_fps, 2),
                "frame": rendered,
                "pairs": int(getattr(renderer, "last_candidates", 0)),
                "capacity": int(getattr(renderer, "capacity", 0)),
            }
            # The frame record's method and stage ms, where the renderer
            # keeps records.
            record = renderer.last_record() if hasattr(renderer, "last_record") else None
            if record is not None:
                stats["method"], stats["stage_ms"] = record["method"], record["stage_ms"]
            state.publish(png, stats)
            rendered += 1
            # 60 FPS spin-wait cap (Demo.cpp:521-525), sleeping politely.
            remaining = dt - (time.perf_counter() - t0)
            if remaining > 0:
                time.sleep(remaining)
    except KeyboardInterrupt:
        pass
    finally:
        state.running = False
        with state.frame_event:
            state.frame_event.notify_all()
        server.shutdown()
        server.server_close()
    return state
