"""The banded stage C-E of the PyTorch port against the JAX package on the
CPU: per-band counts, the banded row arrays (kernels K5 ``interleave_rows_
padded``, K6 ``stack_rows``), the band compaction (K7 ``compact_rows``),
the banded emission (K8 ``emit_slots_banded``), the per-band sort and the
band-offset ranges (K1 in its segmented mode), through their plain PyTorch
versions.

Emission order is deterministic, so every integer output must equal the
JAX function's (Pallas kernels in interpret mode) exactly, slot for slot,
saturated cases included."""

import functools
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudagaussianrenderer_torch as pt
import cudagaussianrenderer_tpu as jx
from cudagaussianrenderer_torch.ops import banded as pbd
from cudagaussianrenderer_torch.ops import binning as pb
from cudagaussianrenderer_torch.ops import expand as pe
from cudagaussianrenderer_torch.ops import ranges as prg
from cudagaussianrenderer_torch.ops.projection import SplatClipData as PtClip
from cudagaussianrenderer_tpu import render as jrender
from cudagaussianrenderer_tpu.ops import banded as jbd
from cudagaussianrenderer_tpu.ops import binning as jb
from cudagaussianrenderer_tpu.ops import expand as je
from cudagaussianrenderer_tpu.ops import ranges as jr
from cudagaussianrenderer_tpu.ops.projection import project_splats as jx_project
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from torch_port_cases import COMPACT_CASES, COMPACT_CG, compact_counts


def T(a) -> torch.Tensor:
    """A JAX or numpy array as a CPU tensor; uint32 words as int32 bits."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def U32(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.astype(a.dtype).view(np.uint32)


HUGE = dict(min_scale=0.3, max_scale=1.6, extent=3.0)


def projected(scene, cfg_kw):
    """A JAX scene's projection under ``cfg_kw``: (JAX config, port config,
    JAX clip data, the same clip data as tensors)."""
    jc, pc = jx.RenderConfig(**cfg_kw), pt.RenderConfig(**cfg_kw)
    cam = jx.Camera(aspect=jc.aspect).framed(scene.bounds_min, scene.bounds_max)
    clip = jx_project(scene.means, scene.scales, scene.quats, cam.camera_data(), jc,
                      opacities=scene.opacities)
    clip_t = PtClip(*[T(getattr(clip, f)) for f in PtClip._fields])
    return jc, pc, clip, clip_t


# ---------------------------------------------------------------------------
# band_counts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tall_wide():
    """Rects taller than 8 rows and wider than 63 tiles among them."""
    scene = jx.random_scene(120, seed=7, min_scale=0.02, max_scale=1.6, extent=3.0)
    jc, pc, clip, clip_t = projected(scene, dict(screen_size=1024))
    jrects = jb.splat_tile_rects(clip, jc)
    jpacks = jb.splat_row_packs(clip, jrects, jc)
    prects = pb.splat_tile_rects(clip_t, pc)
    ppacks = pb.splat_row_packs(clip_t, prects, pc)
    assert (np.asarray(jrects.w) > 63).any() and (np.asarray(jrects.h) > 8).any()
    return jrects, jpacks, prects, ppacks


@pytest.mark.parametrize(
    "band_rows", [[0, 16, 32, 48, 64], [0, 1, 9, 30, 31, 64], [0, 64]],
    ids=["uniform", "non-uniform", "one-band"],
)
def test_band_counts_match_jax_and_partition_the_totals(tall_wide, band_rows):
    jrects, jpacks, prects, ppacks = tall_wide
    want = np.asarray(jbd.band_counts(jrects, jpacks, jnp.asarray(band_rows, jnp.int32)))
    got = pbd.band_counts(prects, ppacks, torch.tensor(band_rows, dtype=torch.int32))
    assert got.dtype == torch.int32 and got.shape == want.shape == (len(band_rows) - 1, 120)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().sum(0), np.asarray(jpacks.counts))
    np.testing.assert_array_equal(ppacks.counts.numpy(), np.asarray(jpacks.counts))


# ---------------------------------------------------------------------------
# K5, K6: the row arrays
# ---------------------------------------------------------------------------

def test_banded_layout_constants_match():
    assert pbd.WINDOW == je.WINDOW
    for n in (1, 300, 4096, 5000, 1_003_520):
        assert pbd.padded_width(n) == -(-(n + 2 * je.WINDOW + 128) // je.PREP_BLK) * je.PREP_BLK
    assert pbd.banded_block(8192, 1024, 4) == 256
    assert pbd.banded_block(1024, 4096, 4) == 256
    assert pbd.banded_block(16 * 65536, 16 * 131072, 16) == 1024
    assert pbd.banded_block(4 * 384, 4 * 1024, 4) == 128


@pytest.mark.parametrize("padded", [False, True], ids=["n-columns", "np-columns"])
def test_interleave_rows_padded_bit_exact(padded):
    """Plain K5 vs the JAX _interleave_rows_padded, from the [n] columns
    (the kernel writes the zero padding) and from columns padded to NP."""
    rng = np.random.default_rng(3)
    n = 700
    np_cols = pbd.padded_width(n)
    cols = [rng.standard_normal(n).astype(np.float32) for _ in range(15)]
    cols[3] = rng.integers(0, 1 << 24, n).astype(np.float32)
    cols_p = [np.pad(c, (0, np_cols - n)) for c in cols]
    want = np.asarray(jbd._interleave_rows_padded(cols_p, np_cols, True))
    got = pbd.interleave_rows_padded([T(c) for c in (cols_p if padded else cols)], np_cols)
    assert got.shape == want.shape == (16, np_cols)
    np.testing.assert_array_equal(U32(got), want.view(np.uint32))
    # The splat-id row is the column index over ALL NP columns.
    np.testing.assert_array_equal(got[2 + pe.R_IDX].numpy(), np.arange(np_cols, dtype=np.float32))


@pytest.mark.parametrize("k", [1, 4, 8])
def test_stack_rows_bit_exact(k):
    rng = np.random.default_rng(k)
    m = 2 * je.PREP_BLK
    cols = [rng.standard_normal(m).astype(np.float32) for _ in range(k)]
    want = np.asarray(jbd._stackk(cols, True))
    got = pbd.stack_rows([T(c) for c in cols])
    assert got.shape == want.shape == (k, m)
    np.testing.assert_array_equal(U32(got), want.view(np.uint32))


def test_row_array_wrappers_reject_bad_arguments():
    col = torch.zeros(8)
    with pytest.raises(ValueError, match="15 columns"):
        pbd.interleave_rows_padded([col] * 14, 4096)
    with pytest.raises(ValueError, match="do not fit"):
        pbd.interleave_rows_padded([col] * 15, 4)
    with pytest.raises(ValueError, match="1 to 8"):
        pbd.stack_rows([col] * 9)
    with pytest.raises(ValueError, match="1 to 8"):
        pbd.stack_rows([])


# ---------------------------------------------------------------------------
# K7: band compaction against a NumPy statement of its contract
# ---------------------------------------------------------------------------

def compact_numpy(full, c_incl, p_excl, p_incl, pair_end, mc):
    """Slot c_incl[g, i] - 1 gets column i's prefixes and attribute rows
    iff p_excl[g, i] != p_incl[g, i]; every other slot of band g gets the
    band's pair end in rows 0-1 and zeros below."""
    g_bands, n = c_incl.shape
    out = np.zeros((16, g_bands * mc), np.float32)
    for g in range(g_bands):
        out[0:2, g * mc:(g + 1) * mc] = pair_end[g]
        for i in range(n):
            if p_excl[g, i] != p_incl[g, i]:
                slot = c_incl[g, i] - 1
                out[0, slot], out[1, slot] = p_excl[g, i], p_incl[g, i]
                out[2:, slot] = full[2:, i]
    return out


@pytest.mark.parametrize("cg,mc", [(4096, 512), (256, 512), (4096, 128)],
                         ids=["roomy", "pair-saturated", "compact-saturated"])
def test_compact_rows_matches_its_contract(cg, mc):
    rng = np.random.default_rng(11)
    g_bands, n = 4, 600
    counts = rng.integers(0, 7, (g_bands, n)).astype(np.int32)
    counts[rng.random((g_bands, n)) < 0.5] = 0
    pre = pbd.band_prefixes(T(counts), cg, mc)
    assert (int(pre.band_totals.max()) > cg) == (cg == 256)
    assert (int(pre.band_splats.max()) > mc) == (mc == 128)

    np_cols = pbd.padded_width(n)
    cols = [rng.standard_normal(n).astype(np.float32) for _ in range(15)]
    full = pbd.interleave_rows_padded([T(c) for c in cols], np_cols)

    pfx = pbd.stack_rows(pbd.band_prefix_columns(pre, np_cols))
    assert pfx.shape == (3, g_bands * np_cols)
    # Pad columns repeat the band's edge values and own nothing.
    tail = pfx.view(3, g_bands, np_cols)[:, :, n:]
    assert (tail[1] == tail[2]).all() and (tail[0] == pre.c_incl[:, -1:]).all()
    got = pbd.compact_rows(full, pfx, pre.pair_end, g_bands * mc)
    want = compact_numpy(full.numpy(), pre.c_incl.numpy(), pre.p_excl.numpy(),
                         pre.p_incl.numpy(), pre.pair_end.numpy(), mc)
    np.testing.assert_array_equal(U32(got), want.view(np.uint32))
    # The compacted inclusive row is monotone: the banded emit relies on it.
    assert (np.diff(got[1].numpy()) >= 0).all()
    # Kept splats' pair ranges tile [g * cg, pair_end_g) without gaps.
    kept = got[0] != got[1]
    for g in range(g_bands):
        sl = slice(g * mc, (g + 1) * mc)
        ex, inc = got[0, sl][kept[sl]].numpy(), got[1, sl][kept[sl]].numpy()
        assert ex[0] == g * cg and inc[-1] == int(pre.pair_end[g])
        np.testing.assert_array_equal(ex[1:], inc[:-1])

    with pytest.raises(ValueError, match="does not split"):
        pbd.compact_rows(full, pfx, pre.pair_end, g_bands * mc + 1)


def jax_compact(full, pre, counts, cg, mc, block):
    """The JAX package's _compact_kernel alone, in interpret mode, launched
    as its emit_pairs_banded launches it (pass 1 there: four stacked prefix
    rows, per-block first owners from its histogram kernel, the scalar
    table), on the port's source rows and prefixes.  Returns the first
    G * mc columns of its array, which has a few blocks of slack behind."""
    (g_bands, n), np_cols = counts.shape, full.shape[1]
    c_incl, p_excl, p_incl = (jnp.asarray(x.numpy()) for x in (pre.c_incl, pre.p_excl, pre.p_incl))
    sel = (counts > 0) & (np.cumsum(counts, axis=1) - counts < cg)

    def pad_band(x, tail):
        fill = jnp.broadcast_to(tail.astype(jnp.float32), (g_bands, np_cols - n))
        return jnp.concatenate([x.astype(jnp.float32), fill], axis=1).reshape(g_bands * np_cols)

    pfx = jbd._stackk([pad_band(c_incl, c_incl[:, -1:]), pad_band(p_excl, p_incl[:, -1:]),
                       pad_band(p_incl, p_incl[:, -1:]), pad_band(p_incl, p_incl[:, -1:])], True)
    shift = block.bit_length() - 1
    np_m = g_bands * mc + -(-(2 * je.WINDOW + 128) // block) * block
    nblocks = np_m // block
    kc = ((c_incl.reshape(-1) + (block - 1)) >> shift).astype(jnp.uint32)
    edges = jr._edges_pallas(kc, nblocks + 2, 0, True)
    starts = edges[1:] + jnp.clip(edges[1:] // n, 0, g_bands - 1) * (np_cols - n)
    band_splats = pre.band_splats.numpy()
    np.testing.assert_array_equal(band_splats, sel.sum(1))
    last_owner = np.where(sel, np.arange(n), 0).max(1)
    scalars = jnp.concatenate([
        starts.astype(jnp.int32),
        jnp.asarray(np.arange(g_bands) * mc + np.minimum(band_splats, mc), jnp.int32),
        jnp.asarray(last_owner, jnp.int32),
        jnp.asarray(pre.pair_end.numpy(), jnp.int32),
    ])
    bps = je.BLOCKS_PER_STEP
    while nblocks % bps:
        bps //= 2
    out = pl.pallas_call(
        functools.partial(jbd._compact_kernel, block=block, bps=bps, bpb=mc // block,
                          n_cols=np_cols, nblocks=nblocks, n_bands=g_bands),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(nblocks // bps,),
            in_specs=[pl.BlockSpec(memory_space=pltpu.HBM), pl.BlockSpec(memory_space=pltpu.HBM)],
            out_specs=[pl.BlockSpec((16, block * bps), lambda i, *_: (0, i))],
            scratch_shapes=[pltpu.VMEM((6, 16, je.WINDOW), jnp.float32),
                            pltpu.VMEM((6, 4, je.WINDOW), jnp.float32),
                            pltpu.SemaphoreType.DMA((6,)), pltpu.SemaphoreType.DMA((6,))]),
        out_shape=[jax.ShapeDtypeStruct((16, np_m), jnp.float32)],
        interpret=True,
    )(scalars, jnp.asarray(full.numpy()), pfx)[0]
    return np.asarray(out)[:, :g_bands * mc]


@pytest.mark.parametrize("name", COMPACT_CASES)
def test_compact_rows_corner_cases_match_jax_kernel_and_contract(name):
    """The cases a kernel that splits the slots by arithmetic can get wrong:
    what the kept columns own must be a prefix of each band's slots, and the
    fill the rest.  Bit-exact against the JAX kernel and the NumPy contract."""
    n, mc = 600, 128
    counts = compact_counts(name, n, mc, seed=len(name))
    pre = pbd.band_prefixes(T(counts), COMPACT_CG, mc)
    kept_g = (pre.p_excl != pre.p_incl).sum(1)
    splats = pre.band_splats
    if name == "empty-band":
        assert int(kept_g[1]) == 0
    elif name == "exactly-full":
        assert int(splats[2]) == int(kept_g[2]) == mc
    elif name == "saturated-then-roomy":
        assert int(splats[1]) > mc == int(kept_g[1]) and int(kept_g[2]) == int(splats[2]) < mc
    elif name == "kept-mod-4":
        assert sorted((kept_g % 4).tolist()) == [0, 1, 2, 3]
    else:
        where = [torch.nonzero(pre.p_excl[g] != pre.p_incl[g])[:, 0] for g in range(4)]
        assert all(int(w[-1] - w[0]) + 1 == len(w) == mc - 1 for w in where)
    # The kept columns of a band own slots [g * mc, g * mc + kept_g) in source order.
    np.testing.assert_array_equal(pre.c_incl[:, -1].numpy(), np.arange(4) * mc + kept_g.numpy())

    rng = np.random.default_rng(1)
    np_cols = pbd.padded_width(n)
    cols = [rng.standard_normal(n).astype(np.float32) for _ in range(15)]
    full = pbd.interleave_rows_padded([T(c) for c in cols], np_cols)
    pfx = pbd.stack_rows(pbd.band_prefix_columns(pre, np_cols))
    got = pbd.compact_rows(full, pfx, pre.pair_end, 4 * mc)
    want = compact_numpy(full.numpy(), pre.c_incl.numpy(), pre.p_excl.numpy(),
                         pre.p_incl.numpy(), pre.pair_end.numpy(), mc)
    np.testing.assert_array_equal(U32(got), want.view(np.uint32))
    np.testing.assert_array_equal(U32(got), jax_compact(full, pre, counts, COMPACT_CG, mc, 128).view(np.uint32))
    # Kept slots are a prefix of every band, the fill is the band's pair end.
    kept_slots = (got[0] != got[1]).view(4, mc)
    for g in range(4):
        k = int(kept_g[g])
        assert kept_slots[g, :k].all() and not kept_slots[g, k:].any()
        assert (got[0:2, g * mc + k:(g + 1) * mc] == float(pre.pair_end[g])).all()
        assert (got[2:, g * mc + k:(g + 1) * mc] == 0).all()


# ---------------------------------------------------------------------------
# K8 (with K5-K7): the banded pair list, through build_tile_pairs_banded
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    scene = jx.random_scene(300, seed=2).pad_to_multiple(256)
    cam = jx.Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    return scene, cam.camera_data()


UNIFORM4 = [0, 2, 4, 6, 8]
# (name, config, band rows, capacity, compact capacity, scene)
BUILD_CASES = [
    ("packed-keys", dict(screen_size=128, sort_bands=4), UNIFORM4, 8192, 1024, "small"),
    ("lex-keys", dict(screen_size=128, sort_bands=4, depth_bits=32), UNIFORM4, 8192, 1024,
     "small"),
    ("non-uniform-rows", dict(screen_size=128, sort_bands=4), [0, 3, 4, 6, 8], 8192, 1024,
     "small"),
    ("default-compact-capacity", dict(screen_size=128, sort_bands=4), UNIFORM4, 8192, 0, "small"),
    ("pair-saturated", dict(screen_size=128, sort_bands=4), UNIFORM4, 1024, 1024, "small"),
    ("compact-saturated", dict(screen_size=128, sort_bands=4), UNIFORM4, 8192, 512, "small"),
    ("reordered-scene", dict(screen_size=128, sort_bands=4), UNIFORM4, 8192, 1024, "reordered"),
    ("huge-splats-256px", dict(screen_size=256, sort_bands=8),
     [0, 1, 3, 4, 8, 9, 12, 15, 16], 32768, 2048, "huge"),
]


@pytest.fixture(scope="module")
def builds(small):
    """Each case built once by both packages: name -> (port pairs, totals,
    splats, JAX pairs, totals, splats, port config, JAX config, band rows,
    capacity)."""
    scene, cam = small
    scenes = {
        "small": scene,
        "reordered": jrender.reorder_scene_by_tile_row(scene, cam, jx.RenderConfig(screen_size=128)),
        "huge": jx.random_scene(40, seed=9, **HUGE).pad_to_multiple(256),
    }
    out = {}
    for name, cfg_kw, rows, capacity, ccap, which in BUILD_CASES:
        sc = scenes[which]
        jc, pc, clip, clip_t = projected(sc, cfg_kw)
        want = jbd.build_tile_pairs_banded(
            clip, sc.colors, sc.opacities, jc, capacity, jnp.asarray(rows, jnp.int32),
            compact_capacity=ccap, interpret=True)
        got = pbd.build_tile_pairs_banded(
            clip_t, T(sc.colors), T(sc.opacities), pc, capacity,
            torch.tensor(rows, dtype=torch.int32), compact_capacity=ccap)
        out[name] = (*got, *want, pc, jc, rows, capacity)
    return out


@pytest.mark.parametrize("name", [c[0] for c in BUILD_CASES])
def test_build_tile_pairs_banded_bit_exact(builds, name):
    got, g_tot, g_spl, want, w_tot, w_spl, pc, _, _, capacity = builds[name]
    np.testing.assert_array_equal(g_tot.numpy(), np.asarray(w_tot))
    np.testing.assert_array_equal(g_spl.numpy(), np.asarray(w_spl))
    assert int(got.num_candidates) == int(want.num_candidates) == int(g_tot.sum())
    assert int(got.num_pairs) == int(want.num_pairs) == int((got.values >= 0).sum())
    assert len(got.keys) == len(want.keys) == (1 if pc.depth_bits == 19 else 2)
    for g, w in zip(got.keys + got.attrs, want.keys + want.attrs):
        assert g.dtype == torch.int32 and g.shape == (capacity,)
        np.testing.assert_array_equal(U32(g), U32(w))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))

    per_band = capacity // pc.sort_bands
    if name == "pair-saturated":
        assert int(g_tot.max()) > per_band
        assert int(got.num_pairs) == int(torch.clamp(g_tot, max=per_band).sum())
    elif name == "compact-saturated":
        assert int(g_spl.max()) > 512 // pc.sort_bands
        assert int(got.num_pairs) < int(g_tot.sum())
    else:
        assert int(got.num_pairs) == int(got.num_candidates)


def pair_multiset(keys, values):
    k = U32(keys[0]).astype(np.uint64)
    if len(keys) > 1:
        k = (k << np.uint64(32)) | U32(keys[1]).astype(np.uint64)
    v = values.numpy() if isinstance(values, torch.Tensor) else np.asarray(values)
    return Counter(zip(k[v >= 0].tolist(), v[v >= 0].tolist()))


def test_banded_pairs_are_the_flat_pairs(builds, small):
    """Unsaturated, the banded list holds exactly the flat list's pairs."""
    scene, cam = small
    got = builds["non-uniform-rows"][0]
    _, pc, _, clip_t = projected(scene, dict(screen_size=128))
    flat = pb.build_tile_pairs(clip_t, T(scene.colors), T(scene.opacities), pc, 8192)
    assert pair_multiset(got.keys, got.values) == pair_multiset(flat.keys, flat.values)
    sat = builds["pair-saturated"][0]
    assert pair_multiset(sat.keys, sat.values) <= pair_multiset(flat.keys, flat.values)


# ---------------------------------------------------------------------------
# Stage D and E on the banded list
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["non-uniform-rows", "lex-keys", "pair-saturated",
                                  "huge-splats-256px"])
def test_sort_and_ranges_banded_exact(builds, name):
    got, _, _, want, _, _, pc, jc, rows, capacity = builds[name]
    g_bands = pc.sort_bands
    jkeys, jvals, jattrs = jbd.sort_pairs_banded(want, g_bands, with_values=True, stable=True)
    pkeys, pvals, pattrs = pbd.sort_pairs_banded(got, g_bands, with_values=True, stable=True)
    for g, w in zip(pkeys + pattrs, jkeys + jattrs):
        np.testing.assert_array_equal(U32(g), U32(w))
    np.testing.assert_array_equal(pvals.numpy(), np.asarray(jvals))

    # Unstable: equal as per-tile multisets, each segment sorted on its own.
    ukeys, uvals, uattrs = pbd.sort_pairs_banded(got, g_bands, with_values=False)
    assert uvals is None
    for g, w in zip(ukeys, jkeys):
        np.testing.assert_array_equal(U32(g), U32(w))  # the keys themselves are sorted
    slot = Counter(zip(*(U32(a).tolist() for a in ukeys + uattrs)))
    assert slot == Counter(zip(*(U32(a).tolist() for a in jkeys + jattrs)))

    want_s, want_c = jr.tile_ranges(jkeys, jc, band_rows=jnp.asarray(rows, jnp.int32),
                                    band_capacity=capacity // g_bands, interpret=True)
    got_s, got_c = prg.tile_ranges(pkeys, pc, band_rows=torch.tensor(rows, dtype=torch.int32),
                                  band_capacity=capacity // g_bands)
    assert got_s.dtype == got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert int(got_c.sum()) == int(got.num_pairs)


def test_segmented_edges_need_no_global_order():
    """K1's plain version on a list sorted per segment only: row s counts
    the keys of segment s alone, sentinels between the segments drop out."""
    seg, probes = 512, 65
    rng = np.random.default_rng(5)
    parts = []
    for lo, hi in ((0, 20), (20, 41), (41, 64)):
        k = np.sort(rng.integers(lo << 19, hi << 19, 300, dtype=np.uint64))
        parts.append(np.concatenate([k, np.full(seg - 300, 0xFFFFFFFF, np.uint64)]))
    keys = T(np.concatenate(parts).astype(np.uint32))
    got = prg.tile_edges(keys, probes, 19, segments=3)
    assert got.shape == (3, probes) and got.dtype == torch.int32
    for s in range(3):
        np.testing.assert_array_equal(
            got[s].numpy(), prg.tile_edges(keys[s * seg:(s + 1) * seg].contiguous(), probes, 19)
        )
        want = np.asarray(jr._edges_pallas(jnp.asarray(parts[s].astype(np.uint32)), probes, 19,
                                           True))
        np.testing.assert_array_equal(got[s].numpy(), want)
    with pytest.raises(ValueError, match="equal segments"):
        prg.tile_edges(keys, probes, 19, segments=5)
    cfg = pt.RenderConfig(screen_size=128)
    with pytest.raises(ValueError, match="do not make up"):
        prg.tile_ranges((keys,), cfg, band_rows=torch.tensor([0, 4, 8], dtype=torch.int32),
                       band_capacity=100)


def test_emit_slots_banded_argument_checks():
    cfg = pt.RenderConfig(screen_size=128, sort_bands=4)
    rows = torch.zeros((16, 1024))
    pair_end = torch.zeros(4, dtype=torch.int32)
    band_rows = torch.tensor(UNIFORM4, dtype=torch.int32)
    with pytest.raises(ValueError, match="whole 256-slot blocks"):
        pe.emit_slots_banded(rows, 4 * 384, cfg, pair_end, band_rows, 256)
    with pytest.raises(ValueError, match="band_rows"):
        pe.emit_slots_banded(rows, 4096, cfg, pair_end, band_rows[:-1], 256)
    with pytest.raises(ValueError, match="multiple of bands"):
        pbd.emit_pairs_banded([torch.zeros(8)] * 13, torch.zeros((4, 8), dtype=torch.int32),
                              band_rows, 4 * 100, cfg)
    with pytest.raises(ValueError, match="compact_capacity"):
        pbd.emit_pairs_banded([torch.zeros(8)] * 13, torch.zeros((4, 8), dtype=torch.int32),
                              band_rows, 4096, cfg, compact_capacity=4 * 100)
