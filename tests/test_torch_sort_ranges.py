"""Stages D-E of the PyTorch port against the JAX package on the CPU: the
pair sort and the tile ranges, with the plain version of kernel K1
(``tile_edges``) held against the JAX ``_edges_pallas`` in interpret
mode.  Every output here is integer and must match exactly."""

import numpy as np
import pytest
import torch

import cudagaussianrenderer_torch as pt
import cudagaussianrenderer_tpu as jx
from cudagaussianrenderer_torch.ops import binning as pb
from cudagaussianrenderer_torch.ops import ranges as pr
from cudagaussianrenderer_torch.ops import sorting as ps
from cudagaussianrenderer_tpu.ops import binning as jb
from cudagaussianrenderer_tpu.ops import ranges as jr
from cudagaussianrenderer_tpu.ops import sorting as js
from cudagaussianrenderer_tpu.ops.projection import project_splats as jx_project

from torch_port_cases import EDGE_CORNER_CASES, edge_corner_keys


def T(a) -> torch.Tensor:
    """A JAX or numpy array as a CPU tensor; uint32 words as int32 bits."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def U32(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32)


# ---------------------------------------------------------------------------
# K1: edges
# ---------------------------------------------------------------------------

# (num_probes, shift, live keys, sentinel pad): probe counts that are and
# are not multiples of 64, key counts that are not a multiple of the JAX
# kernel's 8 x lanes block, keys past the last probe.
EDGE_CASES = [
    (4097, 19, 3000, 1000),
    (65, 0, 777, 0),
    (1000, 0, 5000, 123),
    (129, 19, 1, 2048),
    (2, 0, 64, 64),
]


@pytest.mark.parametrize("num_probes,shift,n_live,n_pad", EDGE_CASES)
def test_tile_edges_exact(num_probes, shift, n_live, n_pad):
    rng = np.random.default_rng(num_probes + n_live)
    # Bins up to a few past the probes, so some live keys drop out too.
    bins = rng.integers(0, num_probes + 3, n_live).astype(np.uint64)
    low = rng.integers(0, 1 << shift, n_live).astype(np.uint64) if shift else 0
    live = ((bins << np.uint64(shift)) | np.uint64(low)).astype(np.uint32)
    keys = np.sort(np.concatenate([live, np.full(n_pad, 0xFFFFFFFF, np.uint32)]))
    want = np.asarray(jr._edges_pallas(keys, num_probes, shift, True))
    got = pr.tile_edges(T(keys), num_probes, shift)
    assert got.dtype == torch.int32 and got.shape == (num_probes,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(EDGE_CORNER_CASES))
def test_tile_edges_corner_cases_exact(name):
    """K1's corner cases, segment by segment against the JAX kernel (which
    takes one sorted list): tiles far apart, an all-sentinel segment, no
    sentinels, lengths no multiple of 4, one probe, 33 probes, 4,097."""
    keys, segments, num_probes, shift = edge_corner_keys(name)
    n = keys.shape[0] // segments
    got = pr.tile_edges(T(keys), num_probes, shift, segments=segments)
    got = got.reshape(segments, num_probes)
    assert got.dtype == torch.int32
    for s in range(segments):
        want = np.asarray(jr._edges_pallas(keys[s * n:(s + 1) * n], num_probes, shift, True))
        np.testing.assert_array_equal(got[s].numpy(), want)


def test_tile_edges_rejects_empty_probe_range():
    with pytest.raises(ValueError):
        pr.tile_edges(torch.zeros(4, dtype=torch.int32), 0, 0)


# ---------------------------------------------------------------------------
# Sort and ranges, on the JAX package's own pair list
# ---------------------------------------------------------------------------

def _pairs(cfg_kw, capacity, n=500, seed=2):
    scene = jx.random_scene(n, seed=seed).pad_to_multiple(256)
    jc, pc = jx.RenderConfig(**cfg_kw), pt.RenderConfig(**cfg_kw)
    cam = jx.Camera(aspect=jc.aspect).framed(scene.bounds_min, scene.bounds_max)
    clip = jx_project(scene.means, scene.scales, scene.quats, cam.camera_data(), jc,
                      opacities=scene.opacities)
    want = jb.build_tile_pairs(clip, scene.colors, scene.opacities, jc, capacity,
                               interpret=True)
    port = pb.TilePairs(
        keys=tuple(T(k) for k in want.keys),
        values=T(want.values),
        attrs=tuple(T(a) for a in want.attrs),
        num_candidates=T(want.num_candidates),
        num_pairs=T(want.num_pairs),
    )
    return jc, pc, want, port


@pytest.fixture(scope="module", params=[19, 32], ids=["packed-key", "lex-keys"])
def pair_lists(request):
    # 2048 slots: the list holds every pair and a sentinel tail.
    return _pairs(dict(screen_size=128, depth_bits=request.param), 2048)


def test_sort_pairs_stable_exact(pair_lists):
    jc, pc, want, port = pair_lists
    wk, wv, wa = js.sort_pairs(want, with_values=True, stable=True)
    gk, gv, ga = ps.sort_pairs(port, with_values=True, stable=True)
    assert len(gk) == len(wk) and len(ga) == len(wa) == 3
    for g, w in zip(gk + ga, wk + wa):
        np.testing.assert_array_equal(U32(g), U32(w))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    # stable=True without values: the same keys and attributes.
    gk2, gv2, ga2 = ps.sort_pairs(port, stable=True)
    assert gv2 is None
    for g, w in zip(gk2 + ga2, wk + wa):
        np.testing.assert_array_equal(U32(g), U32(w))


def test_sort_pairs_unstable_same_multiset(pair_lists):
    """The default unstable sort may order ties differently from XLA's,
    so only the keys must agree slot for slot; every (keys, attrs) record
    must still be present the same number of times."""
    jc, pc, want, port = pair_lists
    wk, _, wa = js.sort_pairs(want)
    gk, gv, ga = ps.sort_pairs(port)
    assert gv is None
    for g, w in zip(gk, wk):
        np.testing.assert_array_equal(U32(g), U32(w))

    def records(ops):
        m = np.stack([U32(o).astype(np.uint64) for o in ops], axis=1)
        return m[np.lexsort(m.T[::-1])]

    np.testing.assert_array_equal(records(gk + ga), records(tuple(wk) + tuple(wa)))


def test_tile_ranges_exact(pair_lists):
    jc, pc, want, port = pair_lists
    wk, _, _ = js.sort_pairs(want, stable=True)
    ws, wc = jr.tile_ranges(wk, jc, interpret=True)
    gs, gc = pr.tile_ranges(tuple(T(k) for k in wk), pc)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    assert int(gc.sum()) == int(want.num_pairs)


def test_tile_ranges_truncated_list_exact():
    """A list cut at capacity still ranges exactly (no sentinel tail)."""
    jc, pc, want, port = _pairs(dict(screen_size=128), 1024)
    assert int(want.num_candidates) > 1024
    wk, _, _ = js.sort_pairs(want, stable=True)
    ws, wc = jr.tile_ranges(wk, jc, interpret=True)
    gs, gc = pr.tile_ranges(tuple(T(k) for k in wk), pc)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


# ---------------------------------------------------------------------------
# Stage D's two paths: the rule that picks one, and the gather's plain twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device_type,key_words,path", [
    ("cuda", 1, "kernel"),
    ("cuda", 2, "torch"),
    ("cpu", 1, "torch"),
    ("cpu", 2, "torch"),
])
def test_sort_path_rule(device_type, key_words, path):
    """The packed key on the card sorts through the kernel; the two-word
    (lex) key keeps the int64 torch.sort whatever the device, and so does
    every CPU tensor."""
    assert ps.sort_path(device_type, key_words) == path


def test_sort_pairs_on_the_cpu_takes_the_torch_path(pair_lists):
    jc, pc, want, port = pair_lists
    before = ps.sort_words.launches
    got = ps.sort_pairs(port, with_values=True)
    assert ps.sort_words.launches == before
    ref = ps._sort_pairs_torch(port, with_values=True)
    for g, w in zip(got[0] + (got[1],) + got[2], ref[0] + (ref[1],) + ref[2]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("words", [0, 1, 3, 4])
def test_sort_words_plain_matches_a_stable_argsort_and_indexing(words):
    """sort_words' plain version: the keys in unsigned order, equal keys in
    slot order, and row w of the words words[w] at the same order, for
    sources longer than the keys (a view of the emit rows)."""
    rng = np.random.default_rng(words)
    n, src_len = 1000, 1300
    keys = np.concatenate([rng.integers(0, 1 << 32, n - 100, dtype=np.uint64).astype(np.uint32),
                           np.full(100, 0xFFFFFFFF, np.uint32)])
    keys[:300] = keys[300:600]  # runs of equal keys
    src = [torch.from_numpy(rng.integers(-2**31, 2**31, src_len, dtype=np.int64).astype(np.int32))
           for _ in range(words)]
    order = np.argsort(keys, kind="stable")
    got_keys, got = ps.sort_words(T(keys), src)
    assert got.dtype == torch.int32 and got.shape == (words, n)
    np.testing.assert_array_equal(U32(got_keys), keys[order])
    for w in range(words):
        np.testing.assert_array_equal(got[w].numpy(), src[w].numpy()[order])


def test_sort_words_refuses_more_than_four_words():
    with pytest.raises(ValueError):
        ps.sort_words(torch.zeros(8, dtype=torch.int32), [torch.zeros(8, dtype=torch.int32)] * 5)
