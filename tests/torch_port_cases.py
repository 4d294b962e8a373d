"""Cases shared by the port's CPU parity tests against the JAX package and
the card-only kernel tests: clip-data edits for the emit tests (each returns
a function that changes a dict of per-splat clip-data arrays, numpy or
torch, in place) and per-band candidate counts for the band compaction;
and helpers of the CLI and viewer tests: the suite's image rule, a free
port, and the comparison of two ``fit`` runs; the eager twin of a
Renderer's graphed frame; and the rank programs of the
multi-device tests (run by parallel.launch.spawn, which starts each rank
from a fresh import of this module).  Imports neither jax nor the JAX
package."""

import dataclasses
import re
import socket

import numpy as np
import pytest
import torch

# The suite's image rule (tests/test_pipeline.py:20-28).
PIX_TOL, BAD_FRAC = 8, 0.02


def image_close(got, want, msg=""):
    """At most BAD_FRAC of the pixels differ by more than PIX_TOL levels."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    bad = (diff > PIX_TOL).any(axis=-1).mean()
    assert bad <= BAD_FRAC, f"{msg}: {bad:.4f} of pixels differ by more than {PIX_TOL}"


# Two CLI fits of the same arguments (the port's and the JAX package's): the
# printed losses (5 decimals) within FIT_LOSS_ATOL; PSNR (2 decimals) and
# SSIM (4 decimals) of each eval within FIT_PSNR_ATOL and FIT_SSIM_ATOL (each
# package renders the fitted scene with its own Renderer); the fitted
# splats' stored values within FIT_PARAM_ATOL (a few f32 roundings through
# the Adam steps).
FIT_LOSS_ATOL, FIT_PSNR_ATOL, FIT_SSIM_ATOL, FIT_PARAM_ATOL = 2e-5, 0.05, 2e-3, 1e-4


def fit_outputs_close(got_err, want_err, got_ply, want_ply, camera):
    """The stderr and the fitted .ply of two ``fit`` runs agree: the losses,
    every PSNR/SSIM line, the splat count, SH degree and stored values
    (rotations aside: the initial splats are isotropic, so their rotation
    has no gradient but rounding noise, which Adam's normalized step makes
    lr-sized), and the two scenes render within the image rule."""
    from cudagaussianrenderer_torch.config import RenderConfig
    from cudagaussianrenderer_torch.render import Renderer
    from cudagaussianrenderer_torch.splatfile import load_scene

    loss = r"fit: loss ([0-9.]+) -> ([0-9.]+)"
    np.testing.assert_allclose([float(x) for x in re.search(loss, got_err).groups()],
                               [float(x) for x in re.search(loss, want_err).groups()],
                               rtol=0, atol=FIT_LOSS_ATOL)
    score = r"PSNR ([0-9.]+) dB, SSIM ([0-9.]+)"
    got_s, want_s = re.findall(score, got_err), re.findall(score, want_err)
    assert len(got_s) == len(want_s)
    for (gp, gs), (wp, ws) in zip(got_s, want_s):
        assert abs(float(gp) - float(wp)) <= FIT_PSNR_ATOL, (gp, wp)
        assert abs(float(gs) - float(ws)) <= FIT_SSIM_ATOL, (gs, ws)
    got, want = load_scene(got_ply, device="cpu"), load_scene(want_ply, device="cpu")
    assert got.count == want.count and got.sh_degree == want.sh_degree
    for f in ("means", "scales", "opacities", "colors", "sh"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=FIT_PARAM_ATOL,
                                       err_msg=f)
    config = RenderConfig(screen_size=32)
    image_close(Renderer(got, config, device="cpu").render(camera),
                Renderer(want, config, device="cpu").render(camera), "fitted scenes")


def rendered_views(n_splats, seed, size, n_views, **scene_kw):
    """(scene, orbit cameras, float RGB targets in [0, 1]): ``n_views``
    orbit views of a random scene rendered by the port's Renderer on the
    CPU, the targets of the fit tests."""
    from cudagaussianrenderer_torch.config import RenderConfig
    from cudagaussianrenderer_torch.models.camera import orbit_cameras
    from cudagaussianrenderer_torch.models.scene import random_scene
    from cudagaussianrenderer_torch.render import Renderer

    scene = random_scene(n_splats, seed=seed, device="cpu", **scene_kw)
    renderer = Renderer(scene, RenderConfig(screen_size=size), device="cpu")
    cams = orbit_cameras(scene.bounds_min, scene.bounds_max, n_views)
    targets = [renderer.render(c)[..., :3].astype(np.float32) / 255.0 for c in cams]
    return scene, cams, targets


def renderer_state(r):
    """What a Renderer's frame leaves in it for the next frame."""
    def listed(a):
        return None if a is None else a.tolist()

    return (r.capacity, getattr(r, "compact_capacity", None), listed(r.band_rows), r.saturated,
            r.last_candidates, r.last_truncated, listed(r.last_band_totals),
            listed(r.last_band_splats))


def eager_render(before, camera, key, band_rows):
    """A frame as the eager Renderer made it: render_frame at ``key`` (the
    renderer's cache key) and ``band_rows``, one readback of the counts, the
    image; then the renderer's controller on those counts, run on
    ``before``, a copy of the renderer made before the frame.  Returns the
    [H, W, 4] u8 image; ``before`` then holds the state after the frame."""
    from cudagaussianrenderer_torch.render import render_frame

    cap, ccap = key if before.banded else (key, 0)
    img, aux = render_frame(before.scene, camera.camera_data(), before.config, cap,
                            band_rows=band_rows, compact_capacity=ccap,
                            device=before.scene.means.device)
    counts = [aux["num_candidates"].reshape(1)]
    if before.banded:
        counts += [aux["band_totals"], aux["band_splats"]]
    counts = torch.cat(counts).cpu().numpy()
    img = img.cpu().numpy()
    if before.banded:
        before._update_banded(counts)
    else:
        before._update_flat(int(counts[0]))
    return img


def free_port() -> int:
    """A TCP port free on the loopback now: test files run in parallel, so a
    server under test never takes a fixed one."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cull_run(lo, hi):
    """Splats [lo, hi) become culled ones (the projection's own marking):
    a run of columns that own no slot."""
    def edit(f):
        f["cx"][lo:hi] = f["cy"][lo:hi] = -128.0
        f["e0"][lo:hi] = f["e1"][lo:hi] = 0.0
    return edit


def widen(*splats):
    """The given splats cover the whole screen, so at 64 tiles across they
    are wider than the 63 tiles a packed run can hold."""
    def edit(f):
        for i in splats:
            f["cx"][i] = f["cy"][i] = f["sin_t"][i] = 0.0
            f["cos_t"][i] = 1.0
            f["e0"][i] = f["e1"][i] = 2.5
    return edit


# The band compaction's corner cases, each a [4, n] table of per-band
# candidate counts for band_prefixes(counts, COMPACT_CG, mc).
COMPACT_CASES = ("empty-band", "exactly-full", "saturated-then-roomy", "kept-mod-4",
                 "dense-in-one-tile")
# Per-band pair capacity of those cases: roomy, so that only the compact
# capacity mc decides what is kept.
COMPACT_CG = 1 << 16


def compact_counts(name, n, mc, seed=0):
    """[4, n] int32 counts (0..6 a column) for one of COMPACT_CASES.

    empty-band: band 1 selects nothing.  exactly-full: band 2 selects
    exactly mc columns.  saturated-then-roomy: band 1 selects 1.5 * mc
    columns, so its last mc / 2 are dropped; band 2 is roomy.  kept-mod-4:
    band g keeps a count that is g modulo 4.  dense-in-one-tile: band g
    selects every column of one run of min(mc - 1, n / 4) neighbours and no
    other, as after a scene reorder by tile row.
    """
    rng = np.random.default_rng(seed)
    bands = 4

    def chosen(k):
        """A row with k random columns of count 1..6."""
        row = np.zeros(n, np.int32)
        row[rng.choice(n, k, replace=False)] = rng.integers(1, 7, k)
        return row

    roomy = max(1, min(mc, n) // 2)
    counts = np.stack([chosen(int(rng.integers(roomy // 2, roomy + 1))) for _ in range(bands)])
    if name == "empty-band":
        counts[1] = 0
    elif name == "exactly-full":
        counts[2] = chosen(mc)
    elif name == "saturated-then-roomy":
        counts[1] = chosen(mc + mc // 2)
    elif name == "kept-mod-4":
        for g in range(bands):
            counts[g] = chosen(roomy // 4 * 4 + g)
    elif name == "dense-in-one-tile":
        w = min(mc - 1, n // bands)
        counts[:] = 0
        for g in range(bands):
            counts[g, g * w:(g + 1) * w] = rng.integers(1, 7, w)
    else:
        raise ValueError(name)
    return counts


# K1's corner cases: name -> (segments, keys a segment, num_probes, shift).
# Each builds [segments * n] uint32 keys, every segment sorted on its own.
EDGE_CORNER_CASES = {
    # Live keys in three tiles only: long runs of empty tiles between them.
    "three-tiles": (1, 6000, 4097, 19),
    # Segment 1 holds only sentinels: one run over every probe.
    "all-sentinel-segment": (4, 3000, 4097, 19),
    # No sentinel anywhere: the position past the last key closes the range.
    "no-sentinels": (4, 2048, 4097, 19),
    # Neither the segment length nor the key count a multiple of 4.
    "odd-lengths": (3, 1001, 65, 0),
    "one-probe": (2, 100, 1, 0),
    # Runs of 32 probes and of 33, either side of the warp's share.
    "33-probes": (3, 640, 33, 0),
    "4097-probes": (2, 5000, 4097, 19),
}


def edge_corner_keys(name, seed=0):
    """(keys [segments * n] uint32, segments, num_probes, shift) of one of
    EDGE_CORNER_CASES."""
    segments, n, num_probes, shift = EDGE_CORNER_CASES[name]
    rng = np.random.default_rng(seed)
    sentinel = np.uint64(0xFFFFFFFF)

    def keyed(bins):
        low = rng.integers(0, 1 << shift, bins.shape[0], dtype=np.uint64)
        return (bins.astype(np.uint64) << np.uint64(shift)) | low

    parts = []
    for s in range(segments):
        live = int(rng.integers(n // 4, n))
        if name == "three-tiles":
            bins = rng.choice(np.array([7, 1500, 3900]), live)
        elif s == 1 and name in ("all-sentinel-segment", "33-probes"):
            live, bins = 0, np.zeros(0, np.int64)
        elif name == "no-sentinels":
            live, bins = n, rng.integers(0, num_probes - 1, n)
        elif name == "33-probes":
            # Segment 0: every key in bin 0, so the first sentinel writes
            # the 32 probes 1..32 (segment 1, all sentinels, writes all
            # 33); segment 2: bin 1, so key 0 writes probes 0..1.
            bins = np.full(live, s // 2)
        else:
            # A few bins past the probes, so that some live keys drop out.
            bins = rng.integers(0, num_probes + 3, live)
        seg = np.concatenate([np.sort(keyed(np.asarray(bins))),
                              np.full(n - live, sentinel, np.uint64)])
        parts.append(seg.astype(np.uint32))
    return np.concatenate(parts), segments, num_probes, shift


SCENE_ARRAYS = ("means", "scales", "quats", "opacities", "colors", "sh")
SCENE_META = ("sh_degree", "count", "bounds_min", "bounds_max")


def scene_numpy(scene):
    """The fields of a scene of either package as NumPy: its arrays (packed
    quaternions as uint32, however each package carries them) and its
    metadata."""
    out = {}
    for f in SCENE_ARRAYS:
        a = getattr(scene, f)
        if a is not None:
            a = a.cpu().numpy() if hasattr(a, "cpu") and hasattr(a, "numpy") else np.asarray(a)
            a = a.view(np.uint32) if a.dtype == np.int32 else a
        out[f] = a
    out.update({f: getattr(scene, f) for f in SCENE_META})
    return out


def assert_same_scene(got, want):
    """Two scenes (the port's and the JAX package's) hold the same arrays
    bit for bit and the same metadata."""
    g, w = scene_numpy(got), scene_numpy(want)
    for f in SCENE_ARRAYS:
        assert (g[f] is None) == (w[f] is None), f
        if g[f] is not None:
            assert g[f].dtype == w[f].dtype and g[f].shape == w[f].shape, f
            np.testing.assert_array_equal(g[f], w[f], err_msg=f)
    for f in SCENE_META:
        assert g[f] == w[f], (f, g[f], w[f])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's tests with one PyTorch CPU thread, then restore the
    count.  The suite runs files in parallel workers; each worker's
    PyTorch otherwise starts a thread per core, and the oversubscribed
    thread pools spin against each other (a 1 s CLI test took 120 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Multi-device cases: the rank programs that parallel.launch.spawn runs
# ---------------------------------------------------------------------------

# The JAX package's multi-device tests (tests/test_distributed.py): 128x128
# frames, a per-rank capacity of 32768 for the skewed scene.
PAR_SIZE = 128
PAR_SHARD_CAP = 32768


def skewed_scene(n_dev, device="cpu"):
    """tests/test_distributed.py's skewed scene for ``n_dev`` ranks:
    512 * n_dev splats (seed 7) squashed into the top 15% of their box, so
    the top uniform band carries most of the pairs."""
    from cudagaussianrenderer_torch import random_scene

    scene = random_scene(512 * n_dev, seed=7, device=device).pad_to_multiple(256 * n_dev)
    m = scene.means.clone()
    m[1] = m[1].max() - (m[1] - m[1].min()) * 0.15
    return dataclasses.replace(scene, means=m)


class SGD:
    """optax.sgd(learning_rate) on the port's parameter trees: updates
    -learning_rate * g, no state (the oracle transform of the
    data-parallel step's tests)."""

    def __init__(self, learning_rate):
        self.learning_rate = learning_rate

    def init(self, params):
        return ()

    def update(self, grads, state, params=None):
        from cudagaussianrenderer_torch.diff import tree_map

        return tree_map(lambda g: -self.learning_rate * g, grads), state


def dp_step(dp, device):
    """One make_train_step_dp step (L2 loss, SGD) on the rank's mesh axis
    "dp", from the inputs ``dp`` (NumPy parameters of diff._splats, camera
    data, targets, and the step's sizes).  Returns (the new parameters'
    leaves as NumPy, the loss)."""
    from cudagaussianrenderer_torch import RenderConfig, diff
    from cudagaussianrenderer_torch.parallel import make_mesh, make_train_step_dp, view_batch

    mesh = make_mesh(axis="dp")
    params = diff._splats(**dp["params"], device=device)
    tx = SGD(dp["lr"])
    step, _ = make_train_step_dp(RenderConfig(screen_size=dp["size"]), dp["capacity"],
                                 dp["k_max"], tx, mesh, l1_weight=0.0, ssim_weight=0.0,
                                 l2_weight=1.0)
    cams, tgts = view_batch(dp["cams"], dp["targets"], device)
    new, _, loss = step(params, tx.init(params), cams, tgts)
    return [x.cpu().numpy() for x in diff.tree_leaves(new)], loss


def gloo_cases(n, dp, cycle):
    """Every multi-device case of one rank of an ``n``-rank gloo group, on
    the CPU: the sharded frames (uniform, balanced, saturated), the
    DistributedRenderer (padding, capacity, 1-D and 2-D batches, custom
    axis names), one data-parallel step (inputs ``dp``) and a fit_dp whose
    views do not divide (inputs ``cycle``).  NumPy results."""
    from cudagaussianrenderer_torch import Camera, RenderConfig, diff, orbit_cameras, random_scene
    from cudagaussianrenderer_torch.parallel import distributed as pd
    from cudagaussianrenderer_torch.parallel import fit_dp, make_mesh

    torch.set_num_threads(1)
    out = {}
    cfg = RenderConfig(screen_size=PAR_SIZE, stable_sort=True)
    mesh = pd.make_mesh()
    scene = skewed_scene(n)
    cam = Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    for name, c in (("uniform", cfg), ("balanced", dataclasses.replace(cfg, balanced_bands=True))):
        img, aux = pd.render_frame_sharded(scene, cam.camera_data(), c, PAR_SHARD_CAP, mesh)
        out[name] = (img.numpy(), int(aux["num_candidates"]), int(aux["num_pairs"]))

    plain = RenderConfig(screen_size=PAR_SIZE)
    s = random_scene(256 * n, seed=3, device="cpu").pad_to_multiple(256 * n)
    c3 = Camera(aspect=1.0).framed(s.bounds_min, s.bounds_max)
    img, aux = pd.render_frame_sharded(s, c3.camera_data(), plain, 256, mesh)
    out["saturated"] = (img.numpy(), int(aux["num_candidates"]), int(aux["num_pairs"]))

    s = random_scene(1000, seed=5, device="cpu")
    c5 = Camera(aspect=1.0).framed(s.bounds_min, s.bounds_max)
    r = pd.DistributedRenderer(s, plain, mesh=mesh)
    first = r.render(c5)
    cap0 = r.capacity
    out["renderer"] = dict(padded=r.scene.padded_count, first=first, cap0=cap0,
                           second=r.render(c5), cap1=r.capacity)

    s = random_scene(400, seed=13, device="cpu")
    r = pd.DistributedRenderer(s, plain, mesh=mesh)
    cams = orbit_cameras(s.bounds_min, s.bounds_max, 3)
    out["batch_1d"] = (r.render_batch(cams, check_saturation=False),
                       np.stack([r.render(c, check_saturation=False) for c in cams]))

    mesh2 = pd.make_mesh_2d(2, n // 2)
    s = random_scene(512, seed=9, device="cpu").pad_to_multiple(512)
    cams = orbit_cameras(s.bounds_min, s.bounds_max, 4)
    imgs, aux = pd.render_frames_sharded(s, pd.stack_cameras(cams), plain, 8192, mesh2)
    out["frames_2d"] = (imgs.numpy(), aux["num_pairs"].numpy())

    s = random_scene(400, seed=7, device="cpu")
    r = pd.DistributedRenderer(s, plain, mesh=pd.make_mesh_2d(2, n // 2, axes=("f", "t")))
    out["custom_axes"] = (r.axes, r.render_batch(orbit_cameras(s.bounds_min, s.bounds_max, 2)))

    out["dp"] = dp_step(dp, "cpu")
    params = diff._splats(**cycle["params"], device="cpu")
    fitted, losses = fit_dp(params, cycle["cams"], cycle["targets"],
                            RenderConfig(screen_size=cycle["size"]), capacity=cycle["capacity"],
                            k_max=cycle["k_max"], mesh=make_mesh(axis="dp"), steps=cycle["steps"],
                            tx=SGD(cycle["lr"]), l1_weight=0.0, ssim_weight=0.0, l2_weight=1.0)
    out["cycle"] = ([x.numpy() for x in diff.tree_leaves(fitted)], losses)
    return out


def mesh_frames_case(n):
    """One rank of an ``n``-rank group on the group's device (each rank its
    own card under NCCL): the skewed scene's uniform and balanced sharded
    frames against the port's single-device band programs on the same
    device (render_frame_multipass with a pass a rank; the sum of
    render_band), and against render_frame by the multi-device rule; then
    one data-parallel Adam step.  Returns (checks: name -> bool, the
    frames as NumPy, the stepped parameters as NumPy).  On the card the
    balanced frame is also held through a DistributedRenderer's graph
    (eager, capture, replay of one key), each frame equal to the eager
    one."""
    from cudagaussianrenderer_torch import Camera, RenderConfig, diff, render_frame
    from cudagaussianrenderer_torch import render_frame_multipass
    from cudagaussianrenderer_torch.parallel import (
        DistributedRenderer, make_mesh, render_band, render_frame_sharded,
    )
    from cudagaussianrenderer_torch.parallel.train import make_train_step_dp, view_batch

    mesh = make_mesh()
    dev = mesh.device
    cfg = RenderConfig(screen_size=PAR_SIZE, stable_sort=True)
    bcfg = dataclasses.replace(cfg, balanced_bands=True)
    scene = skewed_scene(n, dev)
    cam = Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max).camera_data()
    uniform, uaux = render_frame_sharded(scene, cam, cfg, PAR_SHARD_CAP, mesh)
    balanced, baux = render_frame_sharded(scene, cam, bcfg, PAR_SHARD_CAP, mesh)
    flat, faux = render_frame(scene, cam, cfg, PAR_SHARD_CAP * n, device=dev)
    passes, _ = render_frame_multipass(scene, cam, cfg, PAR_SHARD_CAP, n, device=dev)
    bands = sum(render_band(scene, cam, bcfg, PAR_SHARD_CAP, n, d, device=dev)[0].to(torch.int32)
                for d in range(n))

    def close(a, b):
        return bool(((a.to(torch.int32) - b.to(torch.int32)).abs() > 1).float().mean() < 0.001)

    checks = dict(
        uniform_is_multipass=bool(torch.equal(uniform, passes)),
        balanced_is_band_sum=bool(torch.equal(balanced.to(torch.int32), bands)),
        pairs=int(uaux["num_pairs"]) == int(baux["num_pairs"]) == int(faux["num_pairs"]),
        uniform_close=close(uniform, flat), balanced_close=close(balanced, flat),
        balanced_beats_uniform=int(baux["num_candidates"]) < int(uaux["num_candidates"]),
    )
    # The graphed frame: a DistributedRenderer's key visited three times
    # (eager, capture, replay), each frame equal to the eager sharded frame.
    r = DistributedRenderer(scene, bcfg, mesh=mesh)
    r.capacity = PAR_SHARD_CAP
    methods = []
    for _ in range(3):
        got = r.render(Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max),
                       check_saturation=False)
        methods.append(r.last_method)
        checks[f"graphed_{r.last_method}_is_eager"] = bool(np.array_equal(got,
                                                                         balanced.cpu().numpy()))
    checks["graphed_methods"] = methods == ["eager", "capture", "replay"]
    _, cams, targets = rendered_views(48, 3, 32, n)
    params = anisotropic(diff.random_init(24, scene.bounds_min, scene.bounds_max, seed=2,
                                          device=dev))
    tx = diff.Adam(5e-3)
    step, _ = make_train_step_dp(RenderConfig(screen_size=32), 2048, 128, tx, make_mesh(axis="dp"))
    cams_b, tgts_b = view_batch([c.camera_data() for c in cams], targets, dev)
    stepped, _, loss = step(params, tx.init(params), cams_b, tgts_b)
    checks["dp_loss_finite"] = bool(np.isfinite(loss))
    return (checks, uniform.cpu().numpy(), balanced.cpu().numpy(),
            [x.cpu().numpy() for x in diff.tree_leaves(stepped)])


def card_sharded_case(n_bands):
    """One rank of a world-size-1 NCCL group, on the card: the selfcheck's
    balanced-bands scene (cudagaussianrenderer_torch/tools/selfcheck.py:
    BALANCED, 128x128, 500 splats, seed 2) through render_frame_sharded
    (balanced), and the sum of render_band's frames and pair counts for each
    band count of ``n_bands``."""
    import dataclasses

    from cudagaussianrenderer_torch.parallel import make_mesh, render_band, render_frame_sharded
    from cudagaussianrenderer_torch.tools import selfcheck

    mesh = make_mesh()
    case = selfcheck.BALANCED[1]
    scene, cfg, cam = selfcheck.case_scene(case, mesh.device)
    cfg = dataclasses.replace(cfg, balanced_bands=True)
    cap = case["capacity"]
    img, aux = render_frame_sharded(scene, cam, cfg, cap, mesh)
    bands = {}
    for n in n_bands:
        total = torch.zeros(img.shape, dtype=torch.int32, device=mesh.device)
        pairs = 0
        for d in range(n):
            full, baux = render_band(scene, cam, cfg, cap, n, d, device=mesh.device)
            total += full.to(torch.int32)
            pairs += int(baux["num_pairs"])
        bands[n] = (total.cpu().numpy(), pairs)
    return img.cpu().numpy(), int(aux["num_pairs"]), bands


def card_fit_dp_case(size, n_splats, steps):
    """One rank of a world-size-1 NCCL group, on the card: ``steps`` steps
    of fit_dp (Adam, the 3DGS L1 + D-SSIM loss) on two orbit views of a
    random scene, and the same steps by hand (diff.view_loss, loss_grads,
    Adam).  Returns each leaf's max |difference| over its max |value|, and
    the two runs' losses."""
    from cudagaussianrenderer_torch import RenderConfig, diff
    from cudagaussianrenderer_torch.parallel import fit_dp, make_mesh

    dev = make_mesh(axis="dp").device
    scene, cams, targets = rendered_views(n_splats, 3, size, 2)
    cd = [c.camera_data() for c in cams]
    init = anisotropic(diff.random_init(n_splats, scene.bounds_min, scene.bounds_max, seed=1,
                                        device=dev))
    config = RenderConfig(screen_size=size)
    cap, k_max = 1 << 15, 256
    got, got_losses = fit_dp(init, cd, targets, config, capacity=cap, k_max=k_max,
                             mesh=make_mesh(axis="dp"), steps=steps)
    want, want_losses = hand_steps(init, cd, targets, config, cap, k_max, steps, dev)
    return leaf_rel_diffs(got, want), list(got_losses), want_losses


def anisotropic(params, seed=1):
    """``params`` with each splat's log-scales spread apart: an isotropic
    splat's rotation has no gradient but rounding noise, which Adam's
    normalized step makes lr-sized, so runs that should agree would not."""
    stretch = np.random.default_rng(seed).normal(0, 0.4, tuple(params.log_scales.shape))
    return params._replace(log_scales=params.log_scales + torch.from_numpy(
        stretch.astype(np.float32)).to(params.log_scales.device))


def hand_steps(params, cameras_data, targets, config, capacity, k_max, steps, device):
    """fit_dp's steps on one rank, written out: view i % len(views) a step,
    diff.view_loss with the 3DGS weights (L1 0.8, D-SSIM 0.2), its
    gradients (diff.loss_grads), diff.Adam(5e-3).  Returns (params, the
    losses)."""
    from cudagaussianrenderer_torch import diff

    tx = diff.Adam(5e-3)
    p, state, losses = params, tx.init(params), []
    for i in range(steps):
        v = i % len(cameras_data)
        q = diff.tree_map(lambda a: a.detach().requires_grad_(True), p)
        loss, _ = diff.view_loss(q, cameras_data[v], diff.target_tensor(targets[v], device),
                                 config, capacity, k_max, l1_weight=0.8, ssim_weight=0.2,
                                 l2_weight=0.0, device=device)
        grads = diff.loss_grads(loss, diff.tree_leaves(q))
        with torch.no_grad():
            p = diff.tree_map(torch.detach, q)
            upd, state = tx.update(diff.tree_unflatten(p, grads), state, p)
            p = diff.apply_updates(p, upd)
        losses.append(float(loss.detach()))
    return p, losses


def leaf_rel_diffs(got, want):
    """Each leaf's max |got - want| over its max |want|."""
    from cudagaussianrenderer_torch import diff

    return [float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
            for a, b in zip(diff.tree_leaves(got), diff.tree_leaves(want))]


# ---------------------------------------------------------------------------
# The sharded frame's graph cache (tests/test_torch_sharded_graph.py)
# ---------------------------------------------------------------------------

# The selfcheck's scale: 128x128, 350 splats, SH degree 3.
GRAPH_SIZE, GRAPH_SPLATS, GRAPH_SEED = 128, 350, 4
# The capacity key cases: (name, tile-axis ranks, balanced bands, adaptive,
# per-rank capacity to start from).  The start is below the largest band's
# candidates, so the adaptive bucket and the fixed capacity's doubling each
# walk to a second key.
SHARDED_KEY_CASES = (("adaptive-balanced", 2, True, True, 1024),
             ("fixed-uniform", 4, False, False, 512))
# Orbit cameras of the frame cases, and the order a renderer visits them.
GRAPH_CAMERAS = 3
REVISITS = (0, 1, 2, 1, 0)


def graph_scene(device="cpu"):
    from cudagaussianrenderer_torch import random_scene

    return random_scene(GRAPH_SPLATS, seed=GRAPH_SEED, sh_degree=3, device=device)


def key_sequence(mesh, balanced, adaptive, start, cameras):
    """A DistributedRenderer of graph_scene at ``start`` capacity over
    ``cameras``: the key each frame ran at and the capacity after it."""
    from cudagaussianrenderer_torch import RenderConfig
    from cudagaussianrenderer_torch.parallel import distributed as pd

    cfg = RenderConfig(screen_size=GRAPH_SIZE, balanced_bands=balanced,
                       capacity=None if adaptive else start)
    r = pd.DistributedRenderer(graph_scene(), cfg, mesh=mesh)
    r.capacity = start
    keys, run = [], r._run

    def counted(key):
        keys.append(key)
        return run(key)

    r._run = counted
    after = []
    for cam in cameras:
        r.render(cam)
        after.append(r.capacity)
    return keys, after


def renderer_frames(mesh, balanced):
    """REVISITS through DistributedRenderer.render and render_batch over
    its refilled static camera, beside render_frames_tilesharded of the
    same cameras at the same capacity (every frame of the batch on the
    tile axis), all as NumPy."""
    from cudagaussianrenderer_torch import RenderConfig, orbit_cameras
    from cudagaussianrenderer_torch.parallel import distributed as pd

    cfg = RenderConfig(screen_size=GRAPH_SIZE, balanced_bands=balanced)
    scene = graph_scene()
    orbit = orbit_cameras(scene.bounds_min, scene.bounds_max, GRAPH_CAMERAS)
    cams = [orbit[i] for i in REVISITS]
    r = pd.DistributedRenderer(scene, cfg, mesh=mesh)
    r.render(cams[0])  # sizes the capacity from the candidates
    cap = r.capacity
    one = np.stack([r.render(c, check_saturation=False) for c in cams])
    batch = r.render_batch(cams[:4], check_saturation=False)
    want, _ = pd.render_frames_tilesharded(r.scene, pd.stack_cameras(cams), cfg, cap, mesh,
                                           axis=r.tile_axis)
    return dict(capacity=(cap, r.capacity), render=one, batch=batch, want=want.numpy(),
                camera=r._camera.numpy().copy())


def sharded_graph_cases(n):
    """One rank of an ``n``-rank gloo group: the capacity key sequences of
    SHARDED_KEY_CASES run on ``n`` ranks, and renderer_frames on the 1-D
    mesh of every rank (uniform and balanced) and on a 2-D mesh of two
    frame groups (2x1 on two ranks, 2x2 on four)."""
    from cudagaussianrenderer_torch import orbit_cameras
    from cudagaussianrenderer_torch.parallel import distributed as pd

    torch.set_num_threads(1)
    mesh = pd.make_mesh()
    scene = graph_scene()
    cams = orbit_cameras(scene.bounds_min, scene.bounds_max, 6)
    out = {"keys": {name: key_sequence(mesh, balanced, adaptive, start, cams)
                    for name, ranks, balanced, adaptive, start in SHARDED_KEY_CASES
                    if ranks == n}}
    for balanced in (False, True):
        out[("1d", balanced)] = renderer_frames(mesh, balanced)
    out[("2d", False)] = renderer_frames(pd.make_mesh_2d(2, n // 2), False)
    return out


def card_graphed_renderer_case():
    """One rank of a world-size-1 NCCL group, on the card: a
    DistributedRenderer (3000 splats, SH 3, 128x128, 5 orbit cameras) at
    keys A, B, A, B, A, A, and render_batch at key A, beside
    Renderer.render of the same cameras.  Returns (its methods, each frame
    and each batch frame as NumPy, the Renderer's frames, the graph keys)."""
    from cudagaussianrenderer_torch import RenderConfig, Renderer, orbit_cameras, random_scene
    from cudagaussianrenderer_torch.parallel import DistributedRenderer, make_mesh

    mesh = make_mesh()
    scene = random_scene(3000, seed=0, min_scale=0.002, max_scale=0.053, sh_degree=3,
                         device=mesh.device)
    cfg = RenderConfig(screen_size=128)
    cams = orbit_cameras(scene.bounds_min, scene.bounds_max, 5)
    ref = Renderer(scene, cfg, device=mesh.device)
    want = [ref.render(cams[i % 5]) for i in range(6)]
    r = DistributedRenderer(scene, cfg, mesh=mesh)
    a = r._key()
    methods, frames = [], []
    for i, key in enumerate([a, 2 * a, a, 2 * a, a, a]):
        r.capacity = key
        frames.append(r.render(cams[i % 5], check_saturation=False))
        methods.append(r.last_method)
    r.capacity = a
    batch = r.render_batch(cams, check_saturation=False)
    return methods, frames, want, batch, sorted(r._graphs)


def card_failed_sharded_capture_case():
    """One rank of a world-size-1 NCCL group, on the card: a
    DistributedRenderer whose frame waits for the host once its key's
    eager first frame has run.  Returns (whether the capture raised, the
    keys of the graphs kept, how the last frame ran)."""
    from cudagaussianrenderer_torch import Camera, RenderConfig, random_scene
    from cudagaussianrenderer_torch.parallel import DistributedRenderer, make_mesh

    mesh = make_mesh()
    scene = random_scene(500, seed=2, device=mesh.device)
    r = DistributedRenderer(scene, RenderConfig(screen_size=128), mesh=mesh)
    cam = Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    r.render(cam, check_saturation=False)
    frame = r._frame

    def syncing(key):
        image, counts = frame(key)
        counts.sum().item()  # a host sync: not allowed while capturing
        return image, counts

    r._frame = syncing
    try:
        r.render(cam, check_saturation=False)
        raised = False
    except RuntimeError:
        raised = True
    return raised, sorted(r._graphs), r.last_method


# A replaced scene: the selfcheck's scale, scenes A and B of the same count
# (B from the next seed), a fixed capacity that both frames fit, so that
# every frame runs at one key.
SWAP_CAPACITY = 16384


def swap_scenes(device="cpu"):
    from cudagaussianrenderer_torch import random_scene

    return tuple(random_scene(GRAPH_SPLATS, seed=GRAPH_SEED + i, sh_degree=3, device=device)
                 for i in range(2))


def scene_swap_case():
    """One rank of a world-size-1 group (gloo on the CPU, NCCL on the card):
    a DistributedRenderer renders scene A three times (on the card: eager,
    capture, replay), is given scene B as it stands (not padded) and
    renders it once as ``render`` and once as ``render_batch``; beside a
    fresh DistributedRenderer over B at the same capacity.  Returns the
    frames as NumPy, the methods and the saturation flags."""
    from cudagaussianrenderer_torch import Camera, RenderConfig
    from cudagaussianrenderer_torch.parallel import DistributedRenderer, make_mesh

    torch.set_num_threads(1)
    mesh = make_mesh()
    a, b = swap_scenes(mesh.device)
    cfg = RenderConfig(screen_size=GRAPH_SIZE, capacity=SWAP_CAPACITY)
    cam = Camera(aspect=1.0).framed(a.bounds_min, a.bounds_max)
    r = DistributedRenderer(a, cfg, mesh=mesh)
    methods, first = [], []
    for _ in range(3):
        first.append(r.render(cam))
        methods.append(r.last_method)
    r.scene = b
    swapped = r.render(cam)
    methods.append(r.last_method)
    batch = r.render_batch([cam])[0]
    fresh = DistributedRenderer(b, cfg, mesh=mesh)
    fresh.capacity = r.capacity
    return dict(first=first, swapped=swapped, batch=batch, fresh=fresh.render(cam),
                methods=methods, saturated=(r.saturated, fresh.saturated),
                padded=(r.scene.padded_count, fresh.scene.padded_count))


# The scenes of tests/test_edge_cases.py (:21, :41, :66, :87), for either
# package, at one fixed capacity that each fits (the JAX tests start from the
# adaptive capacity; a fixed one renders the same frame with one compile).
EDGE_SCENES = ("single-splat", "one-tile", "huge-splat", "depth-plane")
EDGE_CAPACITY = 16384


def _edge_arrays(name):
    """(scene_from_arrays arguments, bounds or None, RenderConfig options)."""
    unit = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
    identity = np.array([[0.0, 0.0, 0.0, 1.0]], np.float32)
    if name == "single-splat":
        return (dict(means=np.zeros((1, 3), np.float32), scales=np.full((1, 3), 0.3, np.float32),
                     quats_xyzw=identity, opacities=np.array([0.9], np.float32),
                     colors=np.array([[1.0, 0.2, 0.1]], np.float32)),
                unit, dict(screen_size=128))
    if name == "one-tile":
        from cudagaussianrenderer_torch.models.scene import random_scene_arrays

        a = random_scene_arrays(64, seed=1)
        return (dict(means=a["means"], scales=a["scales"], quats_xyzw=a["quats_xyzw"],
                     opacities=a["opacities"], colors=a["colors"]),
                ((-4.0,) * 3, (4.0,) * 3), dict(screen_size=16, tiles_per_cell=1))
    if name == "huge-splat":
        return (dict(means=np.zeros((1, 3), np.float32), scales=np.full((1, 3), 50.0, np.float32),
                     quats_xyzw=identity, opacities=np.array([1.0], np.float32),
                     colors=np.array([[0.0, 1.0, 0.0]], np.float32)),
                unit, dict(screen_size=64, tiles_per_cell=4))
    if name == "depth-plane":
        n = 128
        rng = np.random.default_rng(3)
        means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        means[:, 2] = 0.0  # one camera-space depth plane
        return (dict(means=means, scales=np.full((n, 3), 0.1, np.float32),
                     quats_xyzw=np.tile(identity, (n, 1)),
                     opacities=np.full(n, 0.5, np.float32),
                     colors=rng.uniform(0, 1, (n, 3)).astype(np.float32)),
                unit, dict(screen_size=64, tiles_per_cell=4))
    raise KeyError(name)


def edge_case(name, pkg, *, stable_sort=False, **device):
    """(scene, RenderConfig, Camera) of edge scene ``name`` built by the
    package module ``pkg`` (either package's top level; ``device`` goes to
    the port's scene_from_arrays)."""
    arrays, bounds, cfg = _edge_arrays(name)
    scene = pkg.scene_from_arrays(**arrays, **device)
    scene = dataclasses.replace(scene, bounds_min=bounds[0], bounds_max=bounds[1])
    config = pkg.RenderConfig(**cfg, capacity=EDGE_CAPACITY, stable_sort=stable_sort)
    cam = pkg.Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    return scene, config, cam


def check_edge_frame(name, img, again=None):
    """tests/test_edge_cases.py's own assertions on a frame of ``name``
    (``again``: a second frame of the same renderer, for the tie case)."""
    if name == "single-splat":
        c = img[60:68, 60:68]  # the red-ish splat covers the centre
        assert c[..., 0].max() > 100 and c[..., 3].max() == 255
    elif name == "one-tile":
        assert img.shape == (16, 16, 4) and img[..., 3].max() == 255
    elif name == "huge-splat":
        assert (img[..., 1] > 200).mean() > 0.99  # green everywhere
        assert (img[..., 3] == 255).all()
    else:
        np.testing.assert_array_equal(img, again)  # deterministic despite the ties
        assert img[..., 3].max() == 255
