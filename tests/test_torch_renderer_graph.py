"""The port's Renderer as the JAX Renderer's compiled frame, on the CPU.

On the card ``Renderer.render`` replays one CUDA graph of the frame per
capacity key, the counterpart of the JAX ``_get_fn`` jit cache.  There is
no capture on the CPU, but the CPU runs the same frame function over the
same static inputs, refilled the same way, so these tests hold:

- the cache keys a port Renderer visits, frame by frame, to the keys of
  the JAX Renderer's own ``_get_fn`` (Pallas in interpret mode), with its
  capacity, compact capacity and band rows after each frame;
- every frame over the refilled static inputs to ``render_frame`` at the
  same capacity, compact capacity and band rows, byte for byte;
- the cache's visits (eager, then capture, then replays) with the capture
  replaced by a stand-in that keeps the static-output contract of a graph;
- that a CPU Renderer captures nothing.

The selfcheck's scale: 128x128, 350 splats, SH degree 3."""

import copy

import numpy as np
import pytest
import torch

import cudagaussianrenderer_torch as pt
import cudagaussianrenderer_tpu as jx
from cudagaussianrenderer_torch import render as prender

from torch_port_cases import eager_render, renderer_state

N_SPLATS, SEED = 350, 4
FLAT, BANDED = dict(screen_size=128), dict(screen_size=128, sort_bands=4)


def scenes():
    return (jx.random_scene(N_SPLATS, seed=SEED, sh_degree=3),
            pt.random_scene(N_SPLATS, seed=SEED, sh_degree=3, device="cpu"))


def state(r):
    return (r.capacity, getattr(r, "compact_capacity", None),
            None if r.band_rows is None else r.band_rows.tolist(), r.saturated,
            r.last_candidates)


# (id, config, compact capacity to start from or None).  A fixed capacity
# below the candidates doubles on saturation, a small compact capacity
# doubles when a band holds more splats than its share: both walk keys.
KEY_CASES = [
    ("flat", FLAT, None),
    ("flat-fixed-capacity", dict(FLAT, capacity=512), None),
    ("banded", BANDED, None),
    ("banded-fixed-capacity", dict(BANDED, capacity=512), 512),
]


@pytest.mark.parametrize("cfg_kw,compact", [c[1:] for c in KEY_CASES],
                         ids=[c[0] for c in KEY_CASES])
def test_cache_keys_follow_the_jax_renderer(cfg_kw, compact):
    jscene, pscene = scenes()
    cams = pt.orbit_cameras(pscene.bounds_min, pscene.bounds_max, 6)
    jr = jx.Renderer(jscene, jx.RenderConfig(**cfg_kw), interpret=True)
    pr = pt.Renderer(pscene, pt.RenderConfig(**cfg_kw), device="cpu")
    if compact is not None:
        jr.compact_capacity = pr.compact_capacity = compact
    jkeys, pkeys = [], []
    get_fn, run = jr._get_fn, pr._run

    def jax_get_fn():
        jkeys.append((jr.capacity, getattr(jr, "compact_capacity", None)))
        return get_fn()

    def port_run(key):
        pkeys.append(key if pr.banded else (key, None))
        return run(key)

    jr._get_fn, pr._run = jax_get_fn, port_run
    assert state(pr) == state(jr)
    for i, cam in enumerate(cams):
        jr.render(cam)
        pr.render(cam)
        assert pkeys == jkeys, f"frame {i}"
        assert state(pr) == state(jr), f"frame {i}"
    assert set(pkeys) == set(jr._fns)
    assert len(set(pkeys)) > 1  # the case walks keys


@pytest.mark.parametrize("cfg_kw", [FLAT, BANDED], ids=["flat", "banded"])
def test_frames_over_refilled_inputs_equal_render_frame(cfg_kw):
    """Cameras 0-5, then 2 and 0 again; a banded renderer's rows are also
    set by hand between frames.  Each frame and the state it leaves equal
    the eager frame's (render_frame and the controller on its counts)."""
    _, scene = scenes()
    cams = pt.orbit_cameras(scene.bounds_min, scene.bounds_max, 6)
    r = pt.Renderer(scene, pt.RenderConfig(**cfg_kw), device="cpu")
    for i, c in enumerate([0, 1, 2, 3, 4, 5, 2, 0]):
        if r.banded and i in (3, 6):
            r.band_rows = np.array([0, 1, 2, 7, 8] if i == 3 else [0, 3, 4, 5, 8], np.int32)
        twin = copy.copy(r)
        rows = None if r.band_rows is None else r.band_rows.copy()
        got = r.render(cams[c])
        want = eager_render(twin, cams[c], twin._key(), rows)
        np.testing.assert_array_equal(got, want, err_msg=f"frame {i}, camera {c}")
        assert renderer_state(r) == renderer_state(twin), f"frame {i}"
        np.testing.assert_array_equal(
            r._camera.numpy(), prender.camera_array(cams[c].camera_data()))
        if r.banded:
            np.testing.assert_array_equal(r._band_rows.numpy(), rows)


class StandInGraph:
    """A capture's stand-in on the CPU: the outputs are static tensors
    that each replay overwrites, as a CUDA graph's are."""

    def __init__(self, frame):
        self.frame = frame
        self.outputs = tuple(t.clone() for t in frame())

    def replay(self):
        for dst, src in zip(self.outputs, self.frame()):
            dst.copy_(src)


@pytest.mark.parametrize("cfg_kw", [FLAT, BANDED], ids=["flat", "banded"])
def test_cache_visits_eager_then_capture_then_replays(cfg_kw, monkeypatch):
    """Keys interleaved A, B, A, B, A: each key's first frame eager (sync
    checked), its second captured, later ones replayed, each frame equal
    to render_frame at its key; the graphs share one pool."""
    _, scene = scenes()
    cfg = pt.RenderConfig(**cfg_kw)
    cams = pt.orbit_cameras(scene.bounds_min, scene.bounds_max, 5)
    r = pt.Renderer(scene, cfg, device="cpu")
    checked, captures = [], []

    def run_sync_free(frame):
        checked.append(frame.args)
        return frame()

    def capture_frame(frame, device, *, pool=None, checked=False, error_mode="global",
                      record=None):
        captures.append((frame.args, pool, checked, error_mode))
        graph = StandInGraph(frame)
        return graph, graph.outputs

    monkeypatch.setattr(prender, "run_sync_free", run_sync_free)
    monkeypatch.setattr(prender, "capture_frame", capture_frame)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    r.device = torch.device("cuda")  # the cache's path, over CPU tensors
    a, b = r.capacity, 2 * r.capacity
    if r.banded:
        a, b = (a, r.compact_capacity), (a, 2 * r.compact_capacity)
    methods = []
    for i, key in enumerate([a, b, a, b, a]):
        if r.banded:
            r.capacity, r.compact_capacity = key
        else:
            r.capacity = key
        got = r.render(cams[i], check_saturation=False)
        methods.append(r.last_method)
        cap, ccap = key if r.banded else (key, 0)
        want, _ = pt.render_frame(r.scene, cams[i].camera_data(), cfg, cap, band_rows=r.band_rows,
                                  compact_capacity=ccap, device="cpu")
        np.testing.assert_array_equal(got, want.numpy(), err_msg=f"frame {i}")
    assert methods == ["eager", "eager", "capture", "capture", "replay"]
    assert checked == [(a,), (b,)]
    assert captures == [((a,), "pool", True, "global"), ((b,), "pool", True, "global")]
    assert set(r._graphs) == {a, b}


@pytest.mark.parametrize("cfg_kw", [FLAT, BANDED], ids=["flat", "banded"])
def test_cpu_renderer_captures_nothing(cfg_kw, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU Renderer called a CUDA graph helper")

    monkeypatch.setattr(prender, "capture_frame", refuse)
    monkeypatch.setattr(prender, "run_sync_free", refuse)
    _, scene = scenes()
    r = pt.Renderer(scene, pt.RenderConfig(**cfg_kw), device="cpu")
    cam = pt.Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    for _ in range(3):  # on the card: eager, capture, replay
        r.render(cam)
        r.render(cam, check_saturation=False)
        assert r.last_method == "eager"
    assert r._graphs == {} and r._pool is None
    assert r._camera.device.type == "cpu"
