"""The differentiable rasterizer split into its host part and its device
part, and the fit step's graph key (cudagaussianrenderer_torch/diff.py).

- rasterize_diff with its host part (block_profile, the chunks each block
  of tiles blends) and its device part (tile_order, the tiles by falling
  pair count) is bit-equal, in image and in every gradient, to the
  function as it was before the split: the tile order sorted by NumPy on
  the host and each block's chunks counted there.
- A profile rounded up (round_up_chunks, or every block at k_max's
  chunks) gives a bit-equal image and gradients to the exact one.
- tile_order is np.argsort(-min(counts, k_max), kind="stable"), ties and
  capped counts included, and its inverse.
- fit_step_key changes with each of its parts.

No JAX here: the port's eager rasterizer is held against the JAX package
by tests/test_torch_diff*.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import cudagaussianrenderer_torch as pt
from cudagaussianrenderer_torch import diff
from cudagaussianrenderer_torch.models.scene import random_scene_arrays, scene_from_arrays

from torch_port_cases import one_torch_thread  # noqa: F401 (an autouse fixture)

SIZE = 64
# Four blocks of 4 tiles over the 16 tiles of a 64x64 frame.
TILE_BATCH = 4
CAPACITY = 1 << 14


def before_split(monkeypatch, k_max, tile_batch):
    """rasterize_diff as it was: the order from NumPy's stable argsort of
    the counts read back to the host, each block's chunks from its tiles'
    largest count."""

    def numpy_order(counts, k_max_):
        needed = np.minimum(counts.cpu().numpy(), k_max_)
        order = np.argsort(-needed, kind="stable")
        return torch.from_numpy(order), torch.from_numpy(np.argsort(order, kind="stable"))

    def numpy_profile(counts, config):
        chunk = min(config.raster_chunk, max(8, k_max))
        n_chunks = max(1, -(-k_max // chunk))
        needed = np.minimum(counts, k_max)
        order = np.argsort(-needed, kind="stable")
        return tuple(min(n_chunks, -(-int(needed[order[b:b + tile_batch]].max()) // chunk))
                     for b in range(0, counts.size, tile_batch))

    monkeypatch.setattr(diff, "tile_order", numpy_order)
    return numpy_profile


@pytest.fixture(scope="module")
def dense():
    """A 64x64 view of 2,000 SH-1 splats, 1,250 of them clustered at the
    centre and 400 below it: tiles of 16 to 1,357 pairs (11 chunks)."""
    a = random_scene_arrays(2000, seed=5, sh_degree=1)
    a["means"][:1250] *= 0.08
    a["means"][1250:1650] = a["means"][1250:1650] * 0.1 + np.array([0.0, 3.0, -3.0], np.float32)
    scene = scene_from_arrays(a["means"], a["scales"], a["quats_xyzw"], a["opacities"],
                              a["colors"], a["sh"], 1, device="cpu")
    cam = pt.Camera(aspect=1.0).framed((-4,) * 3, (4,) * 3).camera_data()
    return diff.from_scene(scene), cam


def grads_of(params, cam, config, k_max, **kw):
    """render_diff's image (and depth) and the gradients of a fixed weighted
    sum of them with respect to every DiffSplats leaf."""
    p = diff.tree_map(lambda a: a.detach().requires_grad_(True), params)
    st = diff.build_structure(params, cam, config, CAPACITY, device="cpu")
    out = diff.render_diff(p, cam, config, CAPACITY, k_max, structure=st,
                           tile_batch=TILE_BATCH, return_depth=True, device="cpu", **kw)
    image, depth = out[0], out[1]
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=tuple(image.shape)).astype(np.float32))
    wd = torch.from_numpy(rng.normal(size=tuple(depth.shape)).astype(np.float32))
    loss = torch.sum(image * w) + torch.sum(depth * wd)
    leaves = diff.tree_leaves(p)
    g = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [image.detach(), depth.detach()] + [
        torch.zeros_like(x) if gi is None else gi for gi, x in zip(g, leaves)], st


def assert_bit_equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"output {i}: max |diff| {float((a - b).abs().max())}"


@pytest.mark.parametrize("background,remat", [(None, False), ((0.2, 0.5, 0.9), True)],
                         ids=["plain", "background-remat"])
def test_split_rasterizer_is_bit_equal_to_the_unsplit(dense, monkeypatch, background, remat):
    params, cam = dense
    config = pt.RenderConfig(screen_size=SIZE, background=background)
    k_max = 1024
    got, st = grads_of(params, cam, config, k_max, remat=remat)
    profile = diff.block_profile(st.counts.numpy(), config, k_max, TILE_BATCH)
    split, _ = grads_of(params, cam, config, k_max, remat=remat, profile=profile)
    assert len(set(profile)) > 1, profile  # blocks of different chunk counts
    numpy_profile = before_split(monkeypatch, k_max, TILE_BATCH)
    assert profile == numpy_profile(st.counts.numpy(), config)
    want, _ = grads_of(params, cam, config, k_max, remat=remat,
                       profile=numpy_profile(st.counts.numpy(), config))
    assert_bit_equal(got, want)
    assert_bit_equal(split, want)


def test_background_fills_equal_the_host_tensor():
    bg = (0.2, 0.5, 0.9)
    fills = torch.stack([torch.full((), float(c), dtype=torch.float32) for c in bg])
    assert torch.equal(fills, torch.tensor(bg, dtype=torch.float32))


def test_rounded_profiles_are_bit_equal_to_the_exact(dense):
    params, cam = dense
    config = pt.RenderConfig(screen_size=SIZE)
    k_max = 2048
    exact, st = grads_of(params, cam, config, k_max)
    counts = st.counts.numpy()
    prof = diff.block_profile(counts, config, k_max, TILE_BATCH)
    rounded = tuple(diff.round_up_chunks(c, 16) for c in prof)
    full = (16,) * len(prof)
    assert prof == (11, 4, 1, 1) and rounded == (12, 4, 1, 1), (prof, rounded)
    for profile in (prof, rounded, full):
        got, _ = grads_of(params, cam, config, k_max, profile=profile)
        assert_bit_equal(got, exact)


def test_round_up_chunks():
    got = [diff.round_up_chunks(c, 100) for c in range(0, 42)]
    assert got[:8] == list(range(8))
    assert got[8:18] == [8, 10, 10, 12, 12, 14, 14, 16, 16, 20]
    assert got[33:42] == [40] * 8 + [48]
    assert diff.round_up_chunks(9, 9) == 9 and diff.round_up_chunks(33, 36) == 36
    for c in range(1, 2000):
        r = diff.round_up_chunks(c, 10 ** 6)
        assert c <= r <= 1.25 * c


def test_block_profile_checks_its_blocks(dense):
    params, cam = dense
    config = pt.RenderConfig(screen_size=SIZE)
    st = diff.build_structure(params, cam, config, CAPACITY, device="cpu")
    p = diff.tree_map(lambda a: a.detach(), params)
    clip, opac = diff._project(p, diff._camera(cam, "cpu"), config)
    colors = diff._diff_colors(p, diff._camera(cam, "cpu")["position"])
    for bad in ((1, 1, 1), (9, 1, 1, 1)):
        with pytest.raises(ValueError, match="profile"):
            diff.rasterize_diff(clip, colors, opac, st, config, 1024, tile_batch=TILE_BATCH,
                                profile=bad)


@pytest.mark.parametrize("counts,k_max", [
    (np.random.default_rng(1).integers(0, 5, 1000), 10),      # many ties
    (np.random.default_rng(2).integers(0, 300, 4096), 128),  # capped at k_max: ties again
    (np.zeros(37, np.int64), 4),
    (np.arange(64)[::-1] % 7, 3),
], ids=["ties", "capped", "all-zero", "periodic"])
def test_tile_order_is_numpys_stable_argsort(counts, k_max):
    order, inverse = diff.tile_order(torch.from_numpy(counts.astype(np.int32)), k_max)
    want = np.argsort(-np.minimum(counts, k_max), kind="stable")
    np.testing.assert_array_equal(order.numpy(), want)
    np.testing.assert_array_equal(inverse.numpy(), np.argsort(want, kind="stable"))


def test_fit_step_key_changes_with_each_part():
    params = diff.random_init(10, (-1, -1, -1), (1, 1, 1), sh_degree=1, device="cpu")
    config = pt.RenderConfig(screen_size=32)
    base = dict(params=params, config=config, capacity=4096, k_max=64, n_views=3,
                image_shape=(32, 32))
    flags = dict(loss_weights=(0.8, 0.2, 0.0, 0.0), use_depth=False, sh_warmup=False,
                 optimize_cameras=False, optimize_exposure=False, remat=None)
    key = diff.fit_step_key(**base, **flags)
    assert key == diff.fit_step_key(**base, **flags)
    more = diff.random_init(11, (-1, -1, -1), (1, 1, 1), sh_degree=1, device="cpu")
    sh2 = diff.random_init(10, (-1, -1, -1), (1, 1, 1), sh_degree=2, device="cpu")
    changes = [
        dict(params=more), dict(params=sh2), dict(params=params._replace(sh=None)),
        dict(capacity=8192), dict(k_max=128), dict(n_views=4), dict(image_shape=(32, 64)),
        dict(config=dataclasses.replace(config, falloff="epanechnikov")),
        dict(loss_weights=(0.8, 0.2, 0.0, 0.1)), dict(loss_weights=(1.0, 0.0, 0.0, 0.0)),
        dict(use_depth=True), dict(sh_warmup=True), dict(optimize_cameras=True),
        dict(optimize_exposure=True), dict(remat=True),
    ]
    keys = {key}
    for change in changes:
        kw = {**base, **flags, **change}
        other = diff.fit_step_key(**kw)
        assert other != key, change
        keys.add(other)
    assert len(keys) == len(changes) + 1
