"""Stage C of the PyTorch port against the JAX package on the CPU: the
emit row array (kernel K2, ``interleave_rows``) and the pair-list
emission (kernel K3, ``emit_slots``), through their plain PyTorch
versions.

Emission order is deterministic, so every output must equal the JAX
kernel's (run in interpret mode) bit for bit, slot for slot."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudagaussianrenderer_torch as pt
import cudagaussianrenderer_tpu as jx
from cudagaussianrenderer_torch.ops import binning as pb
from cudagaussianrenderer_torch.ops import expand as pe
from cudagaussianrenderer_torch.ops.projection import SplatClipData as PtClip
from cudagaussianrenderer_tpu.ops import binning as jb
from cudagaussianrenderer_tpu.ops import expand as je
from cudagaussianrenderer_tpu.ops.projection import project_splats as jx_project
from torch_port_cases import cull_run, widen


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


def jax_clip(n, seed, cfg_kw, scene_kw=None, pad=256, edit=None):
    """A JAX scene's projection under ``cfg_kw``: (scene, JAX config,
    port config, JAX clip data, the same clip data as tensors).  ``edit``
    changes the clip data's fields (a dict of numpy arrays) in place before
    either package sees them."""
    scene = jx.random_scene(n, seed=seed, **(scene_kw or {})).pad_to_multiple(pad)
    jc, pc = jx.RenderConfig(**cfg_kw), pt.RenderConfig(**cfg_kw)
    cam = jx.Camera(aspect=jc.aspect).framed(scene.bounds_min, scene.bounds_max)
    clip = jx_project(scene.means, scene.scales, scene.quats, cam.camera_data(), jc,
                      opacities=scene.opacities)
    if edit is not None:
        fields = {f: np.array(getattr(clip, f)) for f in PtClip._fields}
        edit(fields)
        clip = clip._replace(**{f: jnp.asarray(v) for f, v in fields.items()})
    clip_t = PtClip(*[T(getattr(clip, f)) for f in PtClip._fields])
    return scene, jc, pc, clip, clip_t


# ---------------------------------------------------------------------------
# K2: the rows array
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,pad", [(500, 256), (3000, 4096)], ids=["n512", "n4096"])
def test_interleave_rows_bit_exact(n, pad):
    """Plain K2 vs the JAX _interleave_rows, for a splat count that is not a
    multiple of PREP_BLK (the JAX side pads as emit_pairs does) and one
    that is (the production no-pad path)."""
    scene, jc, pc, clip, clip_t = jax_clip(n, 5, dict(screen_size=128), pad=pad)
    cols, incl = pb.emit_columns(clip_t, T(scene.colors), T(scene.opacities), pc)
    capacity = 1024
    total = int(incl[-1])
    # Clamp below the total, so the clamped prefix rows are exercised too.
    assert total > capacity
    clamp = capacity + 1
    got = pe.interleave_rows(incl, cols, clamp)

    n_r = -(-incl.shape[0] // je.PREP_BLK) * je.PREP_BLK
    pad_n = n_r - incl.shape[0]
    incl_j = np.concatenate([incl.numpy(), np.full(pad_n, incl.numpy()[-1], np.int32)])
    cols_j = tuple(np.pad(c.numpy(), (0, pad_n)) for c in cols)
    want = np.asarray(je._interleave_rows(incl_j, cols_j, n_r + je.PREP_BLK, clamp, True))
    assert got.shape == want.shape == (16, pe.rows_width(incl.shape[0]))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def test_emit_layout_constants_match():
    for name in ("MAX_BLOCK", "MAX_EXACT_I32", "MAX_CAPACITY", "R_GEOM", "R_DEPTH", "R_IDX",
                 "R_CX", "R_CY", "R_CA", "R_CB", "R_CC", "R_RGB", "R_ALPHA", "R_PACK0",
                 "NUM_ROWS_IN", "OUT_KEY0", "OUT_KEY1", "OUT_VALUES", "OUT_CXCY",
                 "OUT_CONIC", "OUT_RGBA", "NUM_OUT", "DEPTH_SHIFT", "SENTINEL_KEY",
                 "PREP_BLK"):
        assert getattr(pe, name) == getattr(je, name), name


# ---------------------------------------------------------------------------
# K3: the pair list, through build_tile_pairs
# ---------------------------------------------------------------------------

# (name, config, scene, row_band, capacity, capacity below the total?,
#  clip-data edit, where the capacity cuts the list)
EMIT_CASES = [
    ("default", dict(screen_size=128), (500, 2, None), None, 4096, False, None, None),
    ("default-truncated", dict(screen_size=128), (500, 2, None), None, 1024, True, None, None),
    ("runs-and-extents-off",
     dict(screen_size=128, center_sampled_runs=False, opacity_aware_extents=False),
     (500, 2, None), None, 4096, False, None, None),
    ("lex-keys", dict(screen_size=128, depth_bits=32), (400, 2, None), None, 4096, False,
     None, None),
    ("lex-keys-truncated", dict(screen_size=128, depth_bits=32), (400, 2, None), None, 896, True,
     None, None),
    ("row-band", dict(screen_size=128), (500, 2, None), (2, 5), 2048, False, None, None),
    ("rect-epanechnikov", dict(screen_size=192, screen_height=128, falloff="epanechnikov"),
     (400, 6, None), None, 4096, False, None, None),
    ("huge-fallthrough", dict(screen_size=1024), (12, 9, HUGE), None, 32768, False, None, None),
    ("huge-fallthrough-truncated", dict(screen_size=1024), (12, 9, HUGE), None, 16384, True,
     None, None),
    # What a slot-parallel emission can get wrong.  One splat's 4096 slots
    # across 32 emit blocks of 128 slots:
    ("splat-spans-blocks", dict(screen_size=1024), (12, 9, HUGE), None, 32896, False,
     None, None),
    # 2700 columns that own nothing between two owners:
    ("culled-run", dict(screen_size=128), (3000, 5, None), None, 4096, False,
     cull_run(200, 2900), None),
    # The capacity ends the list inside a splat, in one of its packed runs
    # and in its full-rect fallthrough rows:
    ("cut-in-packed-run", dict(screen_size=128), (500, 2, None), None, 640, True,
     None, "packed"),
    ("cut-in-fallthrough", dict(screen_size=1024), (12, 9, HUGE), None, 8192, True,
     None, "fallthrough"),
    # Two splats wider than 63 tiles (no packed runs) among ordinary ones:
    ("wide-beside-ordinary", dict(screen_size=1024), (300, 3, None), None, 43008, False,
     widen(150, 151), None),
]


def cut_position(clip_t, pc, capacity):
    """Where slot ``capacity`` falls in the splat that owns it: at its
    first slot ('boundary'), in a packed row run or past them."""
    rects = pb.splat_tile_rects(clip_t, pc)
    packs = pb.splat_row_packs(clip_t, rects, pc)
    counts = packs.counts.numpy().astype(np.int64)
    incl = np.cumsum(counts)
    packed = sum(((p.numpy().astype(np.int64) >> 12) & 63) + (p.numpy().astype(np.int64) & 63)
                 for p in packs.packs)
    owner = np.searchsorted(incl, capacity, side="right")
    o = capacity - (incl[owner] - counts[owner])
    return "boundary" if o == 0 else "packed" if o < packed[owner] else "fallthrough"


@pytest.mark.parametrize(
    "name,cfg_kw,scene_args,band,capacity,truncated,edit,cut", EMIT_CASES,
    ids=[c[0] for c in EMIT_CASES],
)
def test_build_tile_pairs_bit_exact(name, cfg_kw, scene_args, band, capacity, truncated, edit,
                                    cut):
    n, seed, scene_kw = scene_args
    scene, jc, pc, clip, clip_t = jax_clip(n, seed, cfg_kw, scene_kw, edit=edit)
    want = jb.build_tile_pairs(clip, scene.colors, scene.opacities, jc, capacity,
                               row_band=band, interpret=True)
    got = pb.build_tile_pairs(clip_t, T(scene.colors), T(scene.opacities), pc, capacity,
                              row_band=band)
    total = int(want.num_candidates)
    assert (total > capacity) == truncated, total
    assert int(got.num_candidates) == total
    assert int(got.num_pairs) == int(want.num_pairs) == min(total, capacity)
    assert len(got.keys) == len(want.keys) == (1 if pc.depth_bits == 19 else 2)
    for g, w in zip(got.keys + got.attrs, want.keys + want.attrs):
        assert g.dtype == torch.int32 and g.shape == (capacity,)
        np.testing.assert_array_equal(U32(g), U32(w))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    rects = jb.splat_tile_rects(clip, jc)
    if scene_kw is not None:
        # The huge splats emit through both full-rect fallthroughs.
        assert (np.asarray(rects.w) > 63).any() and (np.asarray(rects.h) > 8).any()
    if name == "splat-spans-blocks":
        assert pe.emit_block(capacity) == 128 and int(np.asarray(rects.counts).max()) > 1024
    if name == "culled-run":
        assert not np.asarray(rects.counts)[200:2900].any()
        assert np.asarray(rects.counts)[:200].any() and np.asarray(rects.counts)[2900:3000].any()
    if name == "wide-beside-ordinary":
        w = np.asarray(rects.w)
        assert (w[[150, 151]] > 63).all() and (w[:150] < 63).all() and (w[:150] > 0).any()
    if cut is not None:
        assert cut_position(clip_t, pc, capacity) == cut


@pytest.mark.parametrize("capacity", [1024, 8192])
def test_emit_pairs_bit_exact_on_identical_columns(capacity):
    """K2 then K3 on the same 13 columns and prefix: the port's emit_pairs
    against the JAX emit_pairs, all six outputs."""
    scene, jc, pc, clip, clip_t = jax_clip(500, 4, dict(screen_size=128))
    cols, incl = pb.emit_columns(clip_t, T(scene.colors), T(scene.opacities), pc)
    got = pe.emit_pairs(cols, incl, capacity, pc)
    want = je.emit_pairs(tuple(c.numpy() for c in cols), incl.numpy(), capacity, jc,
                         interpret=True)
    assert len(got) == len(want) == pe.NUM_OUT
    for g, w in zip(got, want):
        np.testing.assert_array_equal(U32(g), U32(w))


def test_emit_block_and_capacity_checks():
    assert [pe.emit_block(c) for c in (1024, 4096, 1536, 896, 128)] == [1024, 1024, 512, 128, 128]
    with pytest.raises(ValueError):
        pe.emit_block(1000)
    rows = torch.zeros((16, pe.rows_width(10)), dtype=torch.float32)
    with pytest.raises(ValueError):
        pe.emit_slots(rows, pe.MAX_EXACT_I32, pt.RenderConfig(screen_size=128))
