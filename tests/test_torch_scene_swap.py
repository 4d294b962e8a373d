"""A scene assigned to a renderer renders from the next frame on, as in the
JAX package, whose renderers pass ``self.scene`` to their jitted frame on
every call (cudagaussianrenderer_tpu/render.py:524-528,
parallel/distributed.py:550, 566).

- The port's DistributedRenderer in a world-size-1 gloo group renders
  scene A, is given scene B and renders: byte-equal to a fresh
  DistributedRenderer over B at the same capacity, and within the suite's
  image rule (at most 2% of pixels off by more than 8) of the JAX
  DistributedRenderer given the same assignment.
- The port's Renderer on the graph cache's path (a CPU stand-in for the
  capture, as tests/test_torch_renderer_graph.py drives it): A eager,
  captured, replayed; then B runs eagerly with the old graphs dropped,
  byte-equal to a fresh Renderer over B, and is captured and replayed
  after that.

The selfcheck's scale: 128x128, 350 splats, SH degree 3."""

import numpy as np
import torch

import cudagaussianrenderer_torch as pt
import cudagaussianrenderer_tpu as jx
from cudagaussianrenderer_torch import render as prender
from cudagaussianrenderer_torch.models.scene import GaussianScene
from cudagaussianrenderer_torch.parallel import launch
from cudagaussianrenderer_tpu.ops.expand import PREP_BLK
from cudagaussianrenderer_tpu.parallel import distributed as jd

import torch_port_cases as cases
from torch_port_cases import GRAPH_SEED, GRAPH_SIZE, GRAPH_SPLATS, SWAP_CAPACITY, image_close
from test_torch_renderer_graph import StandInGraph


def test_distributed_renderer_renders_a_replaced_scene():
    got = launch.spawn(cases.scene_swap_case, 1, "cpu")[0]
    assert got["methods"] == ["eager"] * 4
    assert got["saturated"] == (False, False)
    assert got["padded"][0] == got["padded"][1]
    np.testing.assert_array_equal(got["swapped"], got["fresh"])
    np.testing.assert_array_equal(got["batch"], got["fresh"])
    assert not np.array_equal(got["swapped"], got["first"][0])

    scenes = [jx.random_scene(GRAPH_SPLATS, seed=GRAPH_SEED + i, sh_degree=3) for i in range(2)]
    cam = jx.Camera(aspect=1.0).framed(scenes[0].bounds_min, scenes[0].bounds_max)
    cfg = jx.RenderConfig(screen_size=GRAPH_SIZE, capacity=SWAP_CAPACITY)
    jr = jd.DistributedRenderer(scenes[0], cfg, mesh=jd.make_mesh(1))
    want_a = jr.render(cam)
    # The same padded count, so the jitted frame is not traced again.
    jr.scene = scenes[1].pad_to_multiple(PREP_BLK)
    want_b = jr.render(cam)
    assert not jr.saturated and len(jr._fns) == 1
    image_close(got["first"][0], want_a, "scene A against the JAX DistributedRenderer")
    image_close(got["swapped"], want_b, "scene B against the JAX DistributedRenderer")


def test_renderer_drops_its_graphs_for_a_replaced_scene(monkeypatch):
    a, b = cases.swap_scenes()
    cfg = pt.RenderConfig(screen_size=GRAPH_SIZE, capacity=SWAP_CAPACITY)
    cam = pt.Camera(aspect=1.0).framed(a.bounds_min, a.bounds_max)
    captures = []

    def capture_frame(frame, device, *, pool=None, checked=False, error_mode="global",
                      record=None):
        graph = StandInGraph(frame)
        captures.append(graph)
        return graph, graph.outputs

    r = pt.Renderer(a, cfg, device="cpu")
    monkeypatch.setattr(prender, "run_sync_free", lambda frame: frame())
    monkeypatch.setattr(prender, "capture_frame", capture_frame)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())
    # The cache's path over CPU tensors: a "cuda" renderer whose scenes stay put.
    monkeypatch.setattr(GaussianScene, "to", lambda self, device: self)
    r.device = torch.device("cuda")
    methods, frames = [], []
    for i in range(6):
        if i == 3:
            r.scene = b
        frames.append(r.render(cam))
        methods.append(r.last_method)
    assert r._graph_scene is r.scene and r.scene.padded_count == PREP_BLK
    assert methods == ["eager", "capture", "replay"] * 2
    assert len(captures) == 2 and r._graphs[r._key()][0] is captures[1]
    assert not r.saturated
    fresh = pt.Renderer(b, cfg, device="cpu")
    fresh.capacity = r.capacity
    want = fresh.render(cam)
    for i in (3, 4, 5):
        np.testing.assert_array_equal(frames[i], want, err_msg=f"frame {i}")
    assert not np.array_equal(frames[0], want)
    np.testing.assert_array_equal(frames[0], frames[2])
