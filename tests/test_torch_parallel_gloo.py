"""Multi-device rendering and data-parallel fitting of the port
(cudagaussianrenderer_torch.parallel) on gloo process groups of two and
four CPU ranks, started by parallel.launch.spawn.

Each group size is one spawn: every rank runs all the cases of
torch_port_cases.gloo_cases, and each test asserts on their results.
Frames are held against the port's single-device programs: the uniform
sharded frame against render_frame_multipass with a pass a rank, the
balanced one against the sum of render_band's frames (both byte for byte),
and both against render_frame by the JAX package's multi-device rule (a
tile's pair list starts at another offset of a band's list than of the
whole list, so the raster's chunk-aligned early exit may stop elsewhere:
at most 0.1% of the pixels off by more than 1 level) with the same pair
count.  The data-parallel step is held against the JAX package: the mean
of jax.grad of its render_diff over the views, one SGD step (within 1e-5),
as tests/test_distributed.py:187-253 holds its own."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudagaussianrenderer_torch as pt
import cudagaussianrenderer_tpu as jx
from cudagaussianrenderer_torch import diff as pdiff
from cudagaussianrenderer_torch.parallel import distributed as pd
from cudagaussianrenderer_torch.parallel import launch
from cudagaussianrenderer_tpu import diff as jdiff
from cudagaussianrenderer_tpu.parallel import train as jtrain

import torch_port_cases as cases
from torch_port_cases import PAR_SHARD_CAP, PAR_SIZE, one_torch_thread  # noqa: F401

DP_SIZE, DP_CAPACITY, DP_KMAX, DP_LR = 32, 2048, 128, 1e-2
PARAM_FIELDS = ("means", "log_scales", "quats", "opacity_logits", "colors", "sh")


def multi_device_close(got, want, msg=""):
    """tests/test_distributed.py's rule for a sharded frame against the
    single-device one."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert (d > 1).mean() < 0.001, f"{msg}: max diff {d.max()}"


def dp_inputs(n_views, n_splats, scene_seed, init_seed, capacity, k_max, lr, size):
    """A data-parallel case as NumPy: random_init parameters, orbit views of
    a random scene and their targets (the port's Renderer)."""
    scene, cams, targets = cases.rendered_views(n_splats, scene_seed, size, n_views)
    params = pdiff.random_init(n_splats // 2, scene.bounds_min, scene.bounds_max,
                               seed=init_seed, device="cpu")
    return dict(params={f: None if getattr(params, f) is None else getattr(params, f).numpy()
                        for f in PARAM_FIELDS},
                cams=[c.camera_data() for c in cams], targets=targets, size=size,
                capacity=capacity, k_max=k_max, lr=lr)


def cycle_inputs():
    """tests/test_distributed.py:256-290: 3 views for 2 ranks, 4 SGD steps."""
    return dict(dp_inputs(3, 30, 1, 0, 1024, 64, 1e-3, 32), steps=4)


@pytest.fixture(scope="module", params=[2, 4], ids=["2-ranks", "4-ranks"])
def group(request):
    n = request.param
    dp = dp_inputs(n, 48, 3, 2, DP_CAPACITY, DP_KMAX, DP_LR, DP_SIZE)
    cycle = cycle_inputs()
    ranks = launch.spawn(cases.gloo_cases, n, "cpu", n, dp, cycle)
    return n, dp, cycle, ranks


def same_on_every_rank(ranks, key):
    def eq(a, b):
        if isinstance(a, (tuple, list)):
            return len(a) == len(b) and all(eq(x, y) for x, y in zip(a, b))
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(eq(a[k], b[k]) for k in a)
        if isinstance(a, np.ndarray):
            return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
                a.view(np.uint8), b.view(np.uint8))
        return a == b

    assert all(eq(r[key], ranks[0][key]) for r in ranks[1:]), f"{key} differs between ranks"
    return ranks[0][key]


def test_sharded_frames_equal_the_band_programs(group):
    """Uniform: render_frame_multipass with a pass a rank; balanced: the sum
    of render_band over the bands; both byte for byte, every rank the same
    whole frame, and the single-device pair count."""
    n, _, _, ranks = group
    cfg = pt.RenderConfig(screen_size=PAR_SIZE, stable_sort=True)
    bcfg = dataclasses.replace(cfg, balanced_bands=True)
    scene = cases.skewed_scene(n)
    cam = pt.Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max).camera_data()
    flat, flat_aux = pt.render_frame(scene, cam, cfg, PAR_SHARD_CAP * n, device="cpu")
    passes, _ = pt.render_frame_multipass(scene, cam, cfg, PAR_SHARD_CAP, n, device="cpu")
    bands = torch.zeros(flat.shape, dtype=torch.int32)
    band_pairs = 0
    for d in range(n):
        full, aux = pd.render_band(scene, cam, bcfg, PAR_SHARD_CAP, n, d, device="cpu")
        bands += full.to(torch.int32)
        band_pairs += int(aux["num_pairs"])
    uniform, balanced = same_on_every_rank(ranks, "uniform"), same_on_every_rank(ranks, "balanced")
    np.testing.assert_array_equal(uniform[0], passes.numpy())
    np.testing.assert_array_equal(balanced[0], bands.numpy().astype(np.uint8))
    assert uniform[2] == balanced[2] == band_pairs == int(flat_aux["num_pairs"])
    for img in (uniform[0], balanced[0]):
        multi_device_close(img, flat.numpy())


def test_balanced_worst_band_below_uniform(group):
    """On the skewed scene the largest band's candidate count (the
    max over ranks) shrinks when the bands balance (tests/
    test_distributed.py:317-360)."""
    _, _, _, ranks = group
    u, b = ranks[0]["uniform"][1], ranks[0]["balanced"][1]
    assert b < u, f"balanced worst band {b} should beat uniform {u}"


def test_sharded_saturation_truncates(group):
    """A per-rank capacity of 256 truncates, the frame keeps its shape and
    the largest band's candidates say so."""
    _, _, _, ranks = group
    img, cands, pairs = same_on_every_rank(ranks, "saturated")
    assert img.shape == (PAR_SIZE, PAR_SIZE, 4) and img[..., 3].max() == 255
    assert cands > 256 and pairs <= 256 * len(ranks)


def test_distributed_renderer_padding_and_capacity(group):
    n, _, _, ranks = group
    r = same_on_every_rank(ranks, "renderer")
    assert r["padded"] % (256 * n) == 0
    assert r["first"].shape == r["second"].shape == (PAR_SIZE, PAR_SIZE, 4)
    assert r["cap1"] <= r["cap0"]  # adapted to the measured candidate count
    scene = pt.random_scene(1000, seed=5, device="cpu")
    cam = pt.Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    ref = pt.Renderer(scene, pt.RenderConfig(screen_size=PAR_SIZE), device="cpu").render(cam)
    multi_device_close(r["second"], ref, "second frame vs Renderer")


def test_render_batch_1d_mesh_equals_frames(group):
    _, _, _, ranks = group
    batch, frames = same_on_every_rank(ranks, "batch_1d")
    assert batch.shape == (3, PAR_SIZE, PAR_SIZE, 4)
    np.testing.assert_array_equal(batch, frames)


def test_frame_parallel_2d_mesh(group):
    """A (2, n/2) mesh: each frame of the batch against its single-device
    frame, with the same pair count."""
    _, _, _, ranks = group
    imgs, pairs = same_on_every_rank(ranks, "frames_2d")
    assert imgs.shape == (4, PAR_SIZE, PAR_SIZE, 4)
    scene = pt.random_scene(512, seed=9, device="cpu").pad_to_multiple(512)
    cfg = pt.RenderConfig(screen_size=PAR_SIZE)
    for i, cam in enumerate(pt.orbit_cameras(scene.bounds_min, scene.bounds_max, 4)):
        ref, aux = pt.render_frame(scene, cam.camera_data(), cfg, 8192, device="cpu")
        multi_device_close(imgs[i], ref.numpy(), f"frame {i}")
        assert pairs[i] == int(aux["num_pairs"])


def test_distributed_renderer_custom_axis_names(group):
    _, _, _, ranks = group
    axes, imgs = same_on_every_rank(ranks, "custom_axes")
    assert axes == ("f", "t")
    assert imgs.shape == (2, PAR_SIZE, PAR_SIZE, 4) and imgs[..., 3].max() == 255


def _jax_params(p):
    return jdiff.DiffSplats(**{f: None if p[f] is None else jnp.asarray(p[f])
                               for f in PARAM_FIELDS})


@functools.lru_cache(maxsize=None)
def _jax_l2_grad(size, capacity, k_max):
    config = jx.RenderConfig(screen_size=size)

    def one_loss(p, cam, t):
        img, _ = jdiff.render_diff(p, cam, config, capacity, k_max)
        e = img[..., :3] - t
        return jnp.mean(e * e)

    return jax.jit(jax.value_and_grad(one_loss))


def test_dp_step_matches_jax_mean_gradient(group):
    """One step on n ranks is one SGD step on the mean of the JAX
    package's per-view gradients; the loss is the view mean; every rank
    holds the same parameters, bit for bit."""
    n, dp, _, ranks = group
    leaves, loss = same_on_every_rank(ranks, "dp")
    params = _jax_params(dp["params"])
    vg = _jax_l2_grad(dp["size"], dp["capacity"], dp["k_max"])
    losses, grads = [], []
    for cam, t in zip(dp["cams"], dp["targets"]):
        lv, g = vg(params, cam, jnp.asarray(t))
        losses.append(float(lv))
        grads.append(g)
    mean_g = jax.tree_util.tree_map(lambda *gs: sum(gs) / n, *grads)
    want = jax.tree_util.tree_map(lambda p, g: p - dp["lr"] * g, params, mean_g)
    want = jax.tree_util.tree_leaves(want)
    assert len(leaves) == len(want)
    moved = 0
    for got, w, p0 in zip(leaves, want, jax.tree_util.tree_leaves(params)):
        np.testing.assert_allclose(got, np.asarray(w), atol=1e-5)
        moved += int(np.any(got != np.asarray(p0)))
    assert moved >= 4
    assert loss == pytest.approx(float(np.mean(losses)), rel=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_fit_dp(n):
    """The JAX package's fit_dp of cycle_inputs on an n-device mesh."""
    import optax
    from jax.sharding import Mesh

    c = cycle_inputs()
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("dp",))
    return jtrain.fit_dp(
        _jax_params(c["params"]), c["cams"], c["targets"], jx.RenderConfig(screen_size=c["size"]),
        capacity=c["capacity"], k_max=c["k_max"], mesh=mesh, steps=c["steps"],
        tx=optax.sgd(c["lr"]), l1_weight=0.0, ssim_weight=0.0, l2_weight=1.0,
    )


def test_fit_dp_cycles_views(group):
    """3 views cycle to [0, 1, 2, 0] (never drop a view): two groups a
    round on 2 ranks, one on 4.  The losses and fitted parameters of the
    JAX package's fit_dp on as many devices."""
    n, _, cycle, ranks = group
    leaves, losses = same_on_every_rank(ranks, "cycle")
    assert losses.shape == (cycle["steps"],) and np.all(np.isfinite(losses))
    assert np.any(leaves[0] != cycle["params"]["means"])
    want_params, want_losses = _jax_fit_dp(n)
    np.testing.assert_allclose(losses, np.asarray(want_losses), rtol=1e-5)
    for got, w in zip(leaves, jax.tree_util.tree_leaves(want_params)):
        np.testing.assert_allclose(got, np.asarray(w), atol=1e-5)


def test_spawn_refuses_what_it_cannot_run():
    """No process group on the CPU without ranks, and no fallback when the
    card is missing or short of ranks."""
    with pytest.raises(RuntimeError, match="no process group"):
        pd.make_mesh()
    with pytest.raises(RuntimeError):
        launch.spawn(cases.gloo_cases, 2, "cuda", 2, None, None)
    with pytest.raises(ValueError):
        launch.spawn(cases.gloo_cases, 0, "cpu")
