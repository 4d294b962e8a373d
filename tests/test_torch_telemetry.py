"""The port's frame records on the CPU (cudagaussianrenderer_torch.telemetry):
every Renderer.render call leaves one record whose host spans nest inside
their parents, whose stage stamps lie inside its frame, and whose counters
are the frame's; the store keeps the last frames of the process, wraps at
its bound and outlives the Renderer that wrote them.  The card's stamps
are held by tests/test_torch_kernels_cuda.py."""

import gc

import numpy as np
import pytest
import torch

import cudagaussianrenderer_torch as pt
from cudagaussianrenderer_torch import render as prender
from cudagaussianrenderer_torch import telemetry
from cudagaussianrenderer_torch.ops import raster
from cudagaussianrenderer_torch.render import _frame_pairs, camera_tensors

from torch_port_cases import one_torch_thread  # noqa: F401 (one_torch_thread: an autouse fixture)


def tiny_renderer(**cfg_kw):
    scene = pt.random_scene(60, seed=5, sh_degree=1, device="cpu")
    cam = pt.Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    cfg = pt.RenderConfig(screen_size=32, capacity=2048, **cfg_kw)
    return pt.Renderer(scene, cfg, device="cpu"), cam


@pytest.fixture
def store(monkeypatch):
    """A store of its own for the test, of 4 records."""
    s = telemetry.Store(4)
    monkeypatch.setattr(telemetry, "STORE", s)
    return s


def test_names_agree_with_the_reference_stages():
    assert telemetry.STAGES[:6] == prender.STAGE_NAMES
    assert len(telemetry.SPANS) == len(telemetry.PARENTS)
    assert all(p == "" or p in telemetry.SPANS for p in telemetry.PARENTS)
    assert telemetry.STAMPS == len(telemetry.STAGES) + 1


@pytest.mark.parametrize("cfg_kw", [{}, dict(sort_bands=2)], ids=["flat", "banded"])
def test_record_spans_nest_and_stages_lie_inside_the_frame(store, cfg_kw):
    r, cam = tiny_renderer(**cfg_kw)
    keys = []
    for check in (True, False):
        keys.append(r._key() if r.banded else (r._key(), -1))
        r.render(cam, check_saturation=check)
    recs = telemetry.frames()
    assert len(recs) == 2 and (np.diff(recs["seq"]) == 1).all()
    for i, (key, read_counts) in enumerate(zip(keys, (True, False))):
        rec, one = recs[i], recs[i : i + 1]
        assert rec["renderer"] == r._record.id and telemetry.METHODS[rec["method"]] == "eager"
        assert tuple(rec["key"].tolist()) == key
        host = rec["host"]
        had = {name for name, (t0, t1) in zip(telemetry.SPANS, host) if t0 >= 0}
        assert had == {"frame", "inputs", "eager", "readback"}
        for name, parent, (t0, t1) in zip(telemetry.SPANS, telemetry.PARENTS, host):
            if t0 < 0:
                assert t1 < 0, name
                continue
            assert t1 >= t0, name
            if parent:
                p0, p1 = host[telemetry.SPANS.index(parent)]
                assert p0 <= t0 <= t1 <= p1, (name, parent)
        # CPU stamps are the host clock: in order, inside the eager span.
        stamps = rec["device"]
        e0, e1 = host[telemetry.EAGER]
        f0, f1 = host[telemetry.FRAME]
        assert len(stamps) == len(telemetry.STAGES) + 1 and (np.diff(stamps) >= 0).all()
        assert e0 <= stamps[0] and stamps[-1] <= e1
        assert (telemetry.stage_ns(one) >= 0).all()
        assert 0 < telemetry.device_span_ns(one)[0] <= f1 - f0
        counters = dict(zip(telemetry.COUNTERS, rec["counters"].tolist()))
        if read_counts:
            assert counters["candidates"] == r.last_candidates > 0
            assert 0 < counters["blended"] <= counters["pairs"] <= counters["candidates"]
        else:
            assert set(counters.values()) == {-1}


def test_store_wraps_at_its_bound_and_outlives_its_renderer(store):
    r, cam = tiny_renderer()
    rid = r._record.id
    for _ in range(6):
        r.render(cam)
    summary = r.last_record()
    assert summary["method"] == "eager" and list(summary["stage_ms"]) == list(telemetry.STAGES)
    assert 0 < summary["device_ms"] <= summary["host_ms"]["eager"] < summary["host_ms"]["frame"]
    del r
    gc.collect()
    recs = telemetry.frames()
    assert store.n == 6 and len(recs) == 4
    assert (recs["renderer"] == rid).all() and (np.diff(recs["seq"]) == 1).all()
    assert recs["seq"][-1] == summary["seq"]
    assert (recs["device"] >= 0).all() and (telemetry.span_ns(recs, "frame") > 0).all()


def test_a_frame_that_raises_commits_nothing(store, monkeypatch):
    r, cam = tiny_renderer()
    r.render(cam)

    def broken(*a, **kw):
        raise RuntimeError("frame failed")

    monkeypatch.setattr(r, "_frame", broken)
    with pytest.raises(RuntimeError):
        r.render(cam)
    assert store.n == 1


class FakeRing:
    """A card ring's bookkeeping, on the host: ``count`` rows finished, each
    row holding, in every stamp, the number of the last frame it took."""

    def __init__(self, count):
        self.count = count

    def read(self):
        rows = np.arange(telemetry.RING_ROWS)
        last = rows + (self.count - 1 - rows) // telemetry.RING_ROWS * telemetry.RING_ROWS
        return np.repeat(last[:, None], telemetry.STAMPS, axis=1)


def test_frames_reads_each_ring_once_and_drops_rows_it_lost(store, monkeypatch):
    """A card renderer's records get their ring's rows when frames() is
    called; a record older than RING_ROWS frames of its renderer reads -1."""
    ring = FakeRing(telemetry.RING_ROWS + 2)
    monkeypatch.setattr(telemetry, "_RINGS", {77: (lambda: None, ring)})
    words = np.full(telemetry.WORDS, -1, np.int64)
    seqs = (0, 3, telemetry.RING_ROWS, telemetry.RING_ROWS + 1)
    for seq in seqs:
        rec = words.view(telemetry.RECORD)[0]
        rec["renderer"], rec["method"], rec["ring"] = 77, 2, seq
        store.commit(words)
    recs = telemetry.frames()
    assert recs["device"][:, 0].tolist() == [-1, 3, telemetry.RING_ROWS, telemetry.RING_ROWS + 1]


def test_k4_counter_adds_into_the_callers_count():
    """The plain K4 adds its count into the counter it is given, as the
    kernel's atomics do; without one it counts nothing."""
    cfg = pt.RenderConfig(screen_size=32)
    scene = pt.random_scene(60, seed=5, device="cpu").pad_to_multiple(256)
    cam = pt.Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    _, attrs, starts, counts = _frame_pairs(scene, camera_tensors(cam.camera_data(), "cpu"),
                                            cfg, 4096)
    pair_data = raster.pack_pair_data(attrs, cfg.raster_chunk)
    counter = torch.full((1,), 5, dtype=torch.int32)
    plain = raster.rasterize_tiles(pair_data, starts, counts, cfg, blended=counter)
    assert torch.equal(plain, raster.rasterize_tiles(pair_data, starts, counts, cfg))
    assert 5 < int(counter) <= 5 + int(counts.sum())


# Deep lists of large splats, where tiles exit early: (config, the pairs
# blended as the plain version's stats dict counted them, the pairs listed).
BLENDED_CASES = [
    ("tile16", dict(screen_size=64), 1454, 1673),
    ("tile32", dict(screen_size=96, tile_size=32), 988, 1071),
]


@pytest.mark.parametrize("name,cfg_kw,want,listed", BLENDED_CASES,
                         ids=[c[0] for c in BLENDED_CASES])
def test_raster_counter_equals_the_stats_count(name, cfg_kw, want, listed):
    """K4's counter from the plain version equals the count of the stats
    dict it replaces (from the same plain blend, before the counter)."""
    cfg = pt.RenderConfig(**cfg_kw)
    scene = pt.random_scene(192, seed=9, min_scale=0.3, max_scale=1.6, extent=3.0,
                            device="cpu").pad_to_multiple(256)
    cam = pt.Camera(aspect=cfg.aspect).framed(scene.bounds_min, scene.bounds_max)
    _, attrs, starts, counts = _frame_pairs(scene, camera_tensors(cam.camera_data(), "cpu"),
                                            cfg, 65536)
    assert int(counts.sum()) == listed
    blended = torch.zeros(1, dtype=torch.int32)
    raster.rasterize_tiles(raster.pack_pair_data(attrs, cfg.raster_chunk), starts, counts, cfg,
                           blended=blended)
    assert int(blended) == want


@pytest.mark.parametrize("cfg_kw", [{}, dict(sort_bands=2), dict(depth_bits=32)],
                         ids=["flat", "banded", "lex-keys"])
def test_record_notes_the_torch_sort_path_on_the_cpu(store, cfg_kw):
    """A CPU frame sorts with torch.sort whatever its key or bands, and its
    record says so; the card's kernel path is held by
    tests/test_torch_kernels_cuda.py."""
    r, cam = tiny_renderer(**cfg_kw)
    r.render(cam)
    assert telemetry.SORT_PATHS[telemetry.frames()["sort_path"][-1]] == "torch"
    assert r.last_record()["sort_path"] == "torch"
