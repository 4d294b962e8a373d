"""ops.splat.splat_columns on the CPU, where it runs its plain version: the
stage functions it stands for, and the pair list built from its columns.
The kernel itself is held to this plain version on the card
(tests/test_torch_kernels_cuda.py)."""

import pytest
import torch

from cudagaussianrenderer_torch.ops import binning, splat
from cudagaussianrenderer_torch.ops.projection import project_splats
from cudagaussianrenderer_torch.ops.splat import splat_colors

from torch_port_cases import SPLAT_CASES, column_bits, splat_case

IDS = [c[0] for c in SPLAT_CASES]


def stage_functions(scene, cam, config):
    """Stages A and B: (clip data, colors), what binning's columns are made of."""
    clip = project_splats(scene.means, scene.scales, scene.quats, cam, config,
                          opacities=scene.opacities)
    return clip, splat_colors(scene, cam)


@pytest.mark.parametrize("case", SPLAT_CASES, ids=IDS)
def test_plain_splat_columns_equal_the_stage_functions(case):
    scene, cam, config, band = splat_case(case)
    cols, counts = splat.splat_columns(scene, cam, config, row_band=band)
    clip, colors = stage_functions(scene, cam, config)
    want_cols, want_incl = binning.emit_columns(clip, colors, scene.opacities, config,
                                                row_band=band)
    assert len(cols) == len(want_cols) == 13
    for i, (got, want) in enumerate(zip(cols, want_cols)):
        assert torch.equal(column_bits(got), column_bits(want)), f"column {i}"
    assert counts.dtype == torch.int32
    assert torch.equal(torch.cumsum(counts, 0, dtype=torch.int32), want_incl)
    assert cols[splat.ALPHA_COLUMN] is scene.opacities


PAIR_CASES = [c for c in SPLAT_CASES if c[0] in ("default-sh3", "sh2", "runs-off", "band-ints")]


@pytest.mark.parametrize("share", [0.5, 2.0], ids=["truncated", "roomy"])
@pytest.mark.parametrize("case", PAIR_CASES, ids=[c[0] for c in PAIR_CASES])
def test_pairs_from_columns_equal_build_tile_pairs(case, share):
    """build_tile_pairs_from_columns over splat_columns' output gives
    build_tile_pairs' list slot for slot, with a capacity below and above
    the candidate total."""
    scene, cam, config, band = splat_case(case)
    cols, counts = splat.splat_columns(scene, cam, config, row_band=band)
    capacity = max(128, int(int(counts.sum()) * share) // 128 * 128)
    got = binning.build_tile_pairs_from_columns(cols, counts, capacity, config)
    clip, colors = stage_functions(scene, cam, config)
    want = binning.build_tile_pairs(clip, colors, scene.opacities, config, capacity,
                                    row_band=band)
    assert len(got.keys) == len(want.keys) == (1 if config.depth_bits == 19 else 2)
    for g, w in zip(got.keys + (got.values,) + got.attrs, want.keys + (want.values,) + want.attrs):
        assert torch.equal(g, w)
    assert int(got.num_candidates) == int(want.num_candidates) == int(counts.sum())
    assert int(got.num_pairs) == int(want.num_pairs) == min(capacity, int(counts.sum()))
