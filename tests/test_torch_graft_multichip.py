"""The port's multi-device dry run (graft_entry.dryrun_multichip) on gloo
ranks of the CPU, against the JAX repository's __graft_entry__ checks.

Each group size is one spawn.  Two ranks run checks 1-3 and 5; four ranks
also run check 4, the 2-D mesh batch.  Check 1's frame at two ranks is held
against the JAX package's render_frame_sharded on a 2-device mesh of the
virtual CPU devices (the same pair count, and the multi-device rule: under
0.1% of pixels more than 1 level off), and check 3's pair count against the
JAX single-device render_frame's.  Without a card, and with more ranks than
cards, the dry run raises before any process starts."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from cudagaussianrenderer_torch import graft_entry
from cudagaussianrenderer_tpu.config import RenderConfig
from cudagaussianrenderer_tpu.models.camera import Camera
from cudagaussianrenderer_tpu.models.scene import random_scene
from cudagaussianrenderer_tpu.parallel.distributed import make_mesh, render_frame_sharded
from cudagaussianrenderer_tpu.render import render_frame

CHECKS = ("uniform", "balanced", "parity", "dp_step")


@functools.lru_cache(maxsize=None)
def dryrun_on_cpu(n):
    return graft_entry.dryrun_multichip(n, device="cpu")


@pytest.fixture(scope="module", params=[2, 4], ids=["2-ranks", "4-ranks"])
def dryrun(request):
    return request.param, dryrun_on_cpu(request.param)


def test_dryrun_passes_every_check(dryrun):
    n, out = dryrun
    want = CHECKS + (("mesh_2d",) if n == 4 else ())
    assert sorted(out) == sorted(want)
    uniform = out["uniform"]
    assert uniform["image"].shape == (256, 256, 4) and uniform["pairs"] > 0
    assert out["balanced"]["pairs"] == uniform["pairs"]
    assert out["parity"]["frac"] <= 0.001
    assert np.isfinite(out["dp_step"]["loss"]) and out["dp_step"]["moved"] > 0
    for name, check in out.items():
        assert check["seconds"] > 0, name
        # On the CPU the wrappers run their plain versions and launch nothing.
        assert check["launches"] == {k.__name__: 0 for k in graft_entry.KERNELS}, name


def test_check_1_matches_the_jax_sharded_frame():
    n, out = 2, dryrun_on_cpu(2)
    config = RenderConfig(screen_size=256)
    scene = random_scene(256 * n, seed=1, sh_degree=1).pad_to_multiple(256 * n)
    camera = Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    image, aux = jax.jit(lambda s, c: render_frame_sharded(s, c, config, 16384, make_mesh(n)))(
        scene, camera.camera_data())
    assert out["uniform"]["pairs"] == int(np.asarray(aux["num_pairs"]))
    d = np.abs(out["uniform"]["image"].astype(np.int32) - np.asarray(image).astype(np.int32))
    assert (d > 1).mean() < 0.001, f"max diff {d.max()}"


def test_check_3_pairs_match_the_jax_single_device_frame():
    n, out = 2, dryrun_on_cpu(2)
    config = dataclasses.replace(RenderConfig(screen_size=256), stable_sort=True)
    scene = random_scene(256 * n, seed=3, max_scale=0.04, sh_degree=1).pad_to_multiple(256 * n)
    camera = Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    _, aux = jax.jit(lambda s, c: render_frame(s, c, config, 16384 * n))(
        scene, camera.camera_data())
    assert out["parity"]["pairs"] == int(np.asarray(aux["num_pairs"]))


def test_dryrun_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.dryrun_multichip()


def test_more_ranks_than_cards_raises_before_any_process(monkeypatch):
    def spawned(*args, **kwargs):
        raise AssertionError("a process started")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.multiprocessing, "spawn", spawned)
    with pytest.raises(RuntimeError, match="2 ranks need 2 CUDA devices"):
        graft_entry.dryrun_multichip(2)


def test_cpu_ranks_need_a_count():
    with pytest.raises(ValueError, match="number of CPU ranks"):
        graft_entry.dryrun_multichip(device="cpu")
