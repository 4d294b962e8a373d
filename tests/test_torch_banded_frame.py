"""Banded frames (``sort_bands > 1``) of the PyTorch port on the CPU:
against the JAX banded frame (Pallas kernels in interpret mode), against
the golden NumPy oracle and against the port's own flat frame; then the
banded ``Renderer``'s host-side state — boundary controller, capacity
rounding and buckets — against the JAX ``Renderer``'s values.

Frames use the suite's rule (tests/test_pipeline.py): at most 2% of the
pixels may differ by more than 8 levels.  Banded and flat frames of the
port blend the same pairs and may differ only by the tie order of an
unstable sort: at most 2 levels."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudagaussianrenderer_torch as pt
import cudagaussianrenderer_tpu as jx
from cudagaussianrenderer_torch import golden as pgold
from cudagaussianrenderer_torch import render as prender
from cudagaussianrenderer_tpu import render as jrender

PIX_TOL, BAD_FRAC = 8, 0.02


def image_close(got, want, *, pix_tol=PIX_TOL, frac=BAD_FRAC, msg=""):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    bad = (diff > pix_tol).any(axis=-1).mean()
    assert bad <= frac, f"{msg}: {bad:.4f} of pixels differ by more than {pix_tol}"


@pytest.fixture(scope="module")
def setup():
    jscene = jx.random_scene(300, seed=2).pad_to_multiple(256)
    pscene = pt.random_scene(300, seed=2, device="cpu").pad_to_multiple(256)
    cam = jx.Camera(aspect=1.0).framed(jscene.bounds_min, jscene.bounds_max)
    return jscene, pscene, cam.camera_data()


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

def test_banded_frame_matches_jax_golden_and_flat(setup):
    jscene, pscene, cam = setup
    kw = dict(screen_size=128, sort_bands=4)
    rows = [0, 3, 4, 6, 8]
    ccap = 4 * jscene.padded_count
    want_jax, jaux = jx.render_frame(
        jscene, cam, jx.RenderConfig(**kw), 8192, band_rows=jnp.asarray(rows, jnp.int32),
        compact_capacity=ccap, interpret=True)
    got, aux = pt.render_frame(pscene, cam, pt.RenderConfig(**kw), 8192, band_rows=rows,
                               compact_capacity=ccap, device="cpu")
    got = got.numpy()
    assert got.shape == (128, 128, 4) and got.dtype == np.uint8 and got[..., 3].max() == 255
    for k in ("num_candidates", "num_pairs"):
        assert int(aux[k]) == int(jaux[k])
    for k in ("band_totals", "band_splats"):
        np.testing.assert_array_equal(aux[k].numpy(), np.asarray(jaux[k]))
    image_close(got, np.asarray(want_jax), msg="banded vs JAX banded")
    gold = pgold.golden_render(pgold.scene_to_numpy(pscene), cam, pt.RenderConfig(**kw))
    image_close(got, gold, msg="banded vs golden")

    flat, faux = pt.render_frame(pscene, cam, pt.RenderConfig(screen_size=128), 8192,
                                 device="cpu")
    assert int(faux["num_pairs"]) == int(aux["num_pairs"])
    assert np.abs(flat.numpy().astype(int) - got.astype(int)).max() <= 2


def test_banded_frame_default_rows_and_stable_sort(setup):
    """band_rows=None means equal rows; stable_sort threads through the
    banded path and then equals the flat stable frame bit for bit."""
    _, pscene, cam = setup
    cfg = pt.RenderConfig(screen_size=128, sort_bands=4, stable_sort=True)
    a, _ = pt.render_frame(pscene, cam, cfg, 8192, device="cpu")
    b, _ = pt.render_frame(pscene, cam, cfg, 8192, band_rows=prender.uniform_band_rows(cfg),
                           device="cpu")
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    flat, _ = pt.render_frame(pscene, cam, pt.RenderConfig(screen_size=128, stable_sort=True),
                              8192, device="cpu")
    np.testing.assert_array_equal(a.numpy(), flat.numpy())


@pytest.mark.parametrize("capacity,ccap,what", [(1024, 0, "pairs"), (8192, 512, "splats")],
                         ids=["pair-saturated", "compact-saturated"])
def test_saturated_banded_frames_truncate_and_render(setup, capacity, ccap, what):
    _, pscene, cam = setup
    cfg = pt.RenderConfig(screen_size=128, sort_bands=4)
    img, aux = pt.render_frame(pscene, cam, cfg, capacity, compact_capacity=ccap, device="cpu")
    totals, splats = aux["band_totals"].numpy(), aux["band_splats"].numpy()
    if what == "pairs":
        assert (totals > capacity // 4).any()
        assert int(aux["num_pairs"]) == int(np.minimum(totals, capacity // 4).sum())
    else:
        assert (splats > ccap // 4).any()
        assert int(aux["num_pairs"]) < int(totals.sum())
    assert int(aux["num_candidates"]) == int(totals.sum())
    assert img.numpy()[..., 3].max() == 255  # still renders


def test_band_rows_length_validated(setup):
    _, pscene, cam = setup
    cfg = pt.RenderConfig(screen_size=128, sort_bands=8)
    with pytest.raises(ValueError, match="band_rows"):
        pt.render_frame(pscene, cam, cfg, 8192, band_rows=[0, 4, 8], device="cpu")


def test_multipass_refuses_bands(setup):
    _, pscene, cam = setup
    with pytest.raises(ValueError, match="OR multipass"):
        pt.render_frame_multipass(pscene, cam, pt.RenderConfig(screen_size=128, sort_bands=4),
                                  1024, 2, device="cpu")


def test_reorder_scene_by_tile_row(setup):
    """The re-ordered scene holds the same splats, sorted by tile row, and
    renders the frame of the original."""
    _, pscene, cam = setup
    cfg = pt.RenderConfig(screen_size=128, sort_bands=4, stable_sort=True)
    sc2 = prender.reorder_scene_by_tile_row(pscene, cam, cfg)
    clip = prender.project_splats(sc2.means, sc2.scales, sc2.quats,
                                  prender.camera_tensors(cam, "cpu"), cfg,
                                  opacities=sc2.opacities)
    row = torch.clamp(torch.floor((clip.cy + 1.0) * (0.5 * cfg.tiles_y)), 0, cfg.tiles_y - 1)
    assert (torch.diff(row) >= 0).all()
    np.testing.assert_array_equal(np.sort(sc2.opacities.numpy()), np.sort(pscene.opacities.numpy()))
    a, aux_a = pt.render_frame(pscene, cam, cfg, 8192, device="cpu")
    b, aux_b = pt.render_frame(sc2, cam, cfg, 8192, device="cpu")
    assert int(aux_a["num_pairs"]) == int(aux_b["num_pairs"])
    assert (np.abs(a.numpy().astype(int) - b.numpy().astype(int)) > 2).any(-1).mean() <= 0.001


# ---------------------------------------------------------------------------
# Renderer: banded state against the JAX Renderer's values
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [1, 127, 128, 5000, 65536, 1_000_000])
@pytest.mark.parametrize("bands", [1, 4, 16])
def test_round_capacity_bands_match_jax(cap, bands):
    assert prender.round_capacity(cap, "cpu", bands) == jrender.round_capacity(cap, True, bands)
    assert prender.round_capacity(cap, "cuda", bands) == jrender.round_capacity(cap, False, bands)


@pytest.mark.parametrize("kw", [dict(screen_size=128, sort_bands=4),
                                dict(screen_size=1024, sort_bands=16),
                                dict(screen_size=192, screen_height=128, sort_bands=3)],
                         ids=["128-g4", "1024-g16", "rect-g3"])
def test_uniform_band_rows_match_jax(kw):
    got = prender.uniform_band_rows(pt.RenderConfig(**kw))
    want = jrender.uniform_band_rows(jx.RenderConfig(**kw))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


REBALANCE_CASES = [
    ([0, 2, 4, 6, 8], [100, 300, 500, 100], 8),
    ([0, 3, 4, 6, 8], [419, 239, 446, 183], 8),
    ([0, 1, 1, 7, 8], [10, 0, 9000, 10], 8),
    ([0, 4, 8, 12, 16, 20, 24, 28, 32], [5, 50, 900, 4000, 4100, 800, 60, 3], 32),
    ([0, 16, 32, 48, 64], [0, 0, 0, 0], 64),
]


@pytest.mark.parametrize("rows,totals,tiles_y", REBALANCE_CASES,
                         ids=[f"case{i}" for i in range(len(REBALANCE_CASES))])
def test_rebalance_band_rows_match_jax(rows, totals, tiles_y):
    """Both twins of the boundary controller: the tensor one against the
    JAX traced one, the Renderer's NumPy one against the JAX Renderer's."""
    want = np.asarray(jrender.rebalance_band_rows(
        jnp.asarray(rows, jnp.int32), jnp.asarray(totals, jnp.int32), tiles_y))
    got = prender.rebalance_band_rows(torch.tensor(rows, dtype=torch.int32),
                                      torch.tensor(totals, dtype=torch.int32), tiles_y)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == 0 and got[-1] == tiles_y and (np.diff(got.numpy()) >= 0).all()

    kw = dict(screen_size=16 * tiles_y, sort_bands=len(rows) - 1)
    scene_j, scene_p = jx.random_scene(10, seed=0), pt.random_scene(10, seed=0, device="cpu")
    rj = jx.Renderer(scene_j, jx.RenderConfig(**kw), interpret=True)
    rp = pt.Renderer(scene_p, pt.RenderConfig(**kw), device="cpu")
    rj.band_rows = np.asarray(rows, np.int32)
    rp.band_rows = np.asarray(rows, np.int32)
    rj._rebalance_bands(np.asarray(totals, np.int32))
    rp._rebalance_bands(np.asarray(totals, np.int32))
    np.testing.assert_array_equal(rp.band_rows, rj.band_rows)


@pytest.mark.parametrize("bands", [4, 16])
def test_banded_capacity_rules_match_jax(bands):
    kw = dict(screen_size=256, sort_bands=bands)
    rj = jx.Renderer(jx.random_scene(500, seed=1), jx.RenderConfig(**kw), interpret=True)
    rp = pt.Renderer(pt.random_scene(500, seed=1, device="cpu"), pt.RenderConfig(**kw),
                     device="cpu")
    assert rp.banded and rp.n_bands == bands
    assert (rp.capacity, rp.compact_capacity) == (rj.capacity, rj.compact_capacity)
    np.testing.assert_array_equal(rp.band_rows, rj.band_rows)
    for cap in (1, 1000, 65536, 3_000_001, 1 << 30):
        assert rp._round_banded(cap) == rj._round_banded(cap)
    for band_max in (0, 100, 16384, 250_000, 2_000_000):
        assert rp._bucket_banded(band_max) == rj._bucket_banded(band_max)
    flat = pt.Renderer(pt.random_scene(10, seed=1, device="cpu"), pt.RenderConfig(screen_size=64),
                       device="cpu")
    assert not flat.banded and flat.band_rows is None


def test_banded_renderer_rebalances_and_matches_flat():
    """Three frames: the controller moves the rows off uniform and keeps
    them monotone, and every frame shows what the flat Renderer shows."""
    scene = pt.random_scene(400, seed=9, device="cpu")
    cams = pt.orbit_cameras(scene.bounds_min, scene.bounds_max, 3)
    rf = pt.Renderer(scene, pt.RenderConfig(screen_size=128), device="cpu")
    rb = pt.Renderer(scene, pt.RenderConfig(screen_size=128, sort_bands=4), device="cpu")
    rows0 = rb.band_rows.copy()
    for c in cams:
        d = np.abs(rf.render(c).astype(int) - rb.render(c).astype(int))
        assert (d > 2).any(axis=-1).mean() <= 0.001
        assert rb.last_candidates == rf.last_candidates == int(rb.last_band_totals.sum())
        assert rb.capacity == rb._bucket_banded(int(rb.last_band_totals.max()))
    assert not np.array_equal(rb.band_rows, rows0)  # controller moved
    assert rb.band_rows[0] == 0 and rb.band_rows[-1] == 8
    assert (np.diff(rb.band_rows) >= 0).all()
    assert rb.frame_count == 3 and not rb.saturated


def test_banded_renderer_grows_both_capacities():
    scene = pt.random_scene(400, seed=9, device="cpu")
    cam = pt.Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    # A fixed pair capacity doubles after a frame in which a band saturated.
    r = pt.Renderer(scene, pt.RenderConfig(screen_size=128, sort_bands=4, capacity=512),
                    device="cpu")
    assert r.capacity == 512 and not r.adaptive_capacity
    img = r.render(cam)
    assert img[..., 3].max() == 255
    assert r.saturated and int(r.last_band_totals.max()) >= 128
    r.render(cam)
    assert r.capacity == 1024  # Demo.cpp:356-366 behaviour, at the banded grain
    # The compact capacity doubles when a band holds more splats than its share.
    r = pt.Renderer(scene, pt.RenderConfig(screen_size=128, sort_bands=4), device="cpu")
    r.compact_capacity = 512
    r.render(cam)
    assert int(r.last_band_splats.max()) > 128 and r.compact_capacity == 1024
    r.render(cam)
    assert int(r.last_band_splats.max()) <= 256 and r.compact_capacity == 1024


def test_banded_ceiling_warns_once(monkeypatch):
    scene = pt.random_scene(400, seed=9, device="cpu")
    cam = pt.Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    monkeypatch.setattr(pt.Renderer, "MAX_CAPACITY", 1024)
    r = pt.Renderer(scene, pt.RenderConfig(screen_size=128, sort_bands=4), device="cpu")
    assert r.capacity == 1024
    with pytest.warns(RuntimeWarning, match="capacity ceiling"):
        r.render(cam)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        r.render(cam)
    assert r.capacity == 1024


def test_banded_profile_frame():
    scene = pt.random_scene(200, seed=3, sh_degree=1, device="cpu")
    cam = pt.Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    r = pt.Renderer(scene, pt.RenderConfig(screen_size=64, sort_bands=2), device="cpu")
    stages = r.profile_frame(cam, warmup=True)
    assert list(stages) == list(prender.STAGE_NAMES)
    assert all(v >= 0.0 for v in stages.values()) and r.profiled_count == 1
